"""TTA serving engine (``jcf_tpu/infer/engine.py``).

``TTAEngine.features_from_images`` runs the path ``bench.py`` times on a
TPU, in the configuration it ships there (``_CLS_ATTNQ = True``), for
towers under 128 tokens (ViT-B/32's 50, or 82 at 288²):

  source images [B, 3, H, W] bf16 + crop geometry (center + random views)
  -> K1 int8 views [B, N, 3, res, res]          (ops.view_kernel)
  -> im2col (a permute) + int8 GEMM -> int32    (ops.int8_gemm)
  -> K2 flat bf16 rows [B' * S, E]              (ops.assemble_kernel)
  -> int8 tower, K3/K4 per layer; the last layer's attention half K5 on
     the CLS rows (S <= 64) or K3 on all rows (65 to 127 tokens), then
     K4 on the CLS rows                         (ops.block_kernel)
  -> ln_post, proj, L2 norm -> MTA modes [B, D] (models.clip, tta.mta)

Below 128 tokens the int8 tower takes the folded tree in one of the JAX
engine's quantization modes: without ``calibration_images`` every
activation scale is dynamic per row; with them the post-LN scales are
static, and ``static_quant_mode`` makes more of them static: "ln" (only
those), "hidden" (+ the post-GELU hidden), "full" (+ the attention
context), each optionally "+score" (the calibrated softmax shift).

``features_from_crops`` (and its two halves ``crop_features`` and
``mta_from_features``) encodes given crops [B, N, 3, res, res],
CLIP-normalized f32, the JAX engine's ``_encode_cloud``: the float patch
embedding in the compute dtype, CLS, positions, ``ln_pre``, every layer on
every row (K3 + K4, no K5; K6a + K6b in the unquantized engine),
``ln_post`` and ``proj`` on the CLS rows.

From 128 tokens on (ViT-B/16's 197) it takes the route the JAX engine
takes there, whose fold and assembly gates need fewer than 128 tokens:
K1 int8 views, the same int8 patch GEMM, tokens ``acc * k_scale +
k_bias`` in f32, then the composable bf16 tower
(``models.clip.encode_image_tokens``) with the unfolded int8 tree:
dynamic per-row int8 linears (``ops.quant.int8_linear``) and K8
attention (``ops.attention.fused_attention``). No calibration: its
activation scales are per row.

``quant=None`` builds the unquantized engine in ``dtype``: f32 (the
reference preset's engine, and the reference the int8 path is certified
against: top-1 agreement, top-5 overlap, as ``bench.py`` certifies the
JAX int8 engine) or bf16 (``bench.py``'s ``JCF_BENCH_QUANT=none`` parity
configuration). Below 128 tokens it takes the JAX engine's route there:
K1 views in ``dtype``, the patch embedding (a matmul of the views in
``dtype`` with f32 accumulation, plus the folded normalization bias),
CLS, positions and ``ln_pre`` in ``dtype``, then the unquantized fused
tower on every layer and every row (``models.clip._run_blocks``: K6a
with the mask-free paired attention, K6b), ``ln_post`` and ``proj``. From
128 tokens on the tower is the composable one with K8 attention.

The engine runs on one ``device``, the CUDA card unless the caller asks
for another. Calibration and the f32 engine run f32 products on the card,
so full-f32 products (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` both False) are required there; the
bf16 patch embedding of ``crop_features`` on the card needs
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False`` (``ops.layers.linear``). The classifier it scores against is the
[C, D] output of ``pipelines.common.build_text_weights`` (or any
unit-norm [C, D] tensor).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from jcf_tpu_torch.models.clip import (
    CLIP_MEAN,
    CLIP_STD,
    CLIPConfig,
    _patchify,
    encode_cls_tail,
    encode_image,
    encode_image_tokens,
    fold_normalize_into_embed,
    tree_to,
    vision_ln_z_amax,
)
from jcf_tpu_torch.ops.assemble_kernel import assemble_dense_rows, make_cls_row
from jcf_tpu_torch.ops.attention import BLOCKED_MIN_SEQ
from jcf_tpu_torch.ops.block_kernel import dense_rows_eligible, run_fused_tower
from jcf_tpu_torch.ops.int8_gemm import int8_gemm_s32
from jcf_tpu_torch.ops.layers import l2_normalize, require_f32_products
from jcf_tpu_torch.ops.quant import quantize_clip_params, true_div
from jcf_tpu_torch.ops.view_kernel import CROP_SCALE, fused_views_nchw, sample_view_centers
from jcf_tpu_torch.tta.mta import solve_mta_batch

# static_quant_mode's base -> the quantizations beside the post-LN pair
# that go static (jcf_tpu/infer/engine.py:384-401)
STATIC_MODES = {"ln": (), "hidden": ("hidden",), "full": ("ctx", "hidden")}


def _embed_quant(w4f: torch.Tensor, fb: torch.Tensor):
    """int8 patch embed from the normalization-folded f32 weight
    w4f [C, p, p, E] and bias fb [E]: per-channel int8 weight [E, C*p*p],
    dequant scale kscale / 254, and bias fb + rowsum(W) * 127/254 (the
    view kernel's +127 pixel offset, folded)."""
    flat = w4f.permute(3, 0, 1, 2).reshape(w4f.shape[3], -1)  # [E, C*p*p]
    kscale = torch.clamp_min(true_div(flat.abs().amax(dim=1), 127.0), 1e-8)
    k_q = torch.clamp(torch.round(flat / kscale[:, None]), -127, 127).to(torch.int8).contiguous()
    bias_i8 = fb + flat.sum(dim=1) * (127.0 / 254.0)
    return k_q, true_div(kscale, 254.0), bias_i8


def static_act(static_quant_mode: str):
    """"<base>[+score]" -> (``act_static`` for ``quantize_clip_params``,
    whether the calibration takes the score columns). Raises
    ``ValueError`` on any other mode."""
    base, _, suffix = static_quant_mode.partition("+")
    if base not in STATIC_MODES or suffix not in ("", "score"):
        raise ValueError(f"unknown static_quant_mode {static_quant_mode!r}")
    with_scores = suffix == "score"
    return STATIC_MODES[base] + (("score",) if with_scores else ()), with_scores


class TTAEngine:
    """Images or crops -> MTA mode features / logits on one device.

    params: the CLIP param tree (f32 CPU tensors, ``models.clip`` layout).
    quant: "int8" (below 128 tokens the folded tree with dynamic scales,
    or with ``calibration_images`` the static scales that
    ``static_quant_mode`` names; from 128 on the unfolded tree, both
    ignored, as the JAX engine does) or None (the unquantized engine).
    dtype: the compute dtype; with ``quant=None`` f32 (the default) or
    bf16, the int8 engine bf16 only (the default there).
    crop_scale: the random views' area range, a share of the source's.
    """

    def __init__(self, params: dict, cfg: CLIPConfig, *, device="cuda", n_views: int = 8,
                 quant: Optional[str] = "int8", dtype: Optional[torch.dtype] = None,
                 calibration_images=None, static_quant_mode: str = "full",
                 crop_scale: Tuple[float, float] = CROP_SCALE):
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_views = n_views  # random views per image; the center view is added
        self.crop_scale = tuple(crop_scale)
        self.quant = quant
        dev = self.device
        v = params["visual"]
        w4, fold_bias = fold_normalize_into_embed(
            v["patch_embed"]["w"], CLIP_MEAN, CLIP_STD, cfg.vision_patch_size
        )
        if quant is None:
            self.dtype = torch.float32 if dtype is None else dtype
            if self.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"the unquantized engine computes in f32 or bf16, not {self.dtype}")
            # the float params cast to the compute dtype, as the JAX engine casts them
            self._params = {"visual": tree_to(v, dev, self.dtype)}
            self._quant = None
            self._w_embed = w4.permute(3, 0, 1, 2).reshape(w4.shape[3], -1).to(dev, self.dtype)
            self._b_embed = fold_bias.to(dev)
            return
        if quant != "int8":
            raise ValueError(f"unknown quant mode {quant!r}")
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"the int8 engine computes in bf16, not {dtype}")
        self.dtype = torch.bfloat16
        self._k_q, self._k_scale, self._k_bias = _embed_quant(w4.to(dev), fold_bias.to(dev))
        # bf16 copies of the float params, as the JAX engine casts them
        self._params = {"visual": tree_to(v, dev, torch.bfloat16)}
        if cfg.vision_seq_len >= BLOCKED_MIN_SEQ:
            # the composable tower: the unfolded tree from the f32 params
            self._quant = quantize_clip_params({"visual": tree_to(v, dev)}, fold=False)["visual"]
            return
        if not dense_rows_eligible(cfg.vision_seq_len, cfg.vision_heads):
            # the JAX engine's route for these towers skips the row assembly
            # (jcf_tpu/infer/engine.py:491-501); ROADMAP.md, Queue 1 item 5
            raise ValueError(
                f"{cfg.vision_heads} heads, S = {cfg.vision_seq_len}: the int8 engine assembles "
                f"dense rows, the reference's route for an even head count (an odd one takes the "
                f"masked attention, use_mask=True) and S not a multiple of 16; the engine's "
                f"non-assembled route is not ported")
        params_dev = {"visual": tree_to(v, dev)}
        act_scales, act_static_ = None, ()
        if calibration_images is not None:
            require_f32_products(dev, "calibration")
            act_static_, with_scores = static_act(static_quant_mode)
            amax = vision_ln_z_amax(params_dev, cfg, self._calibration_crops(calibration_images),
                                    with_scores=with_scores)
            act_scales = {"visual": amax}
        self._quant = quantize_clip_params(
            params_dev, fold=True, heads={"visual": cfg.vision_heads}, act_scales=act_scales,
            act_static=act_static_,
        )["visual"]
        bf16 = self._params["visual"]
        self._pos_tail = bf16["positional_embedding"][1:].contiguous()
        self._ln_pre = bf16["ln_pre"]
        self._cls_row = make_cls_row(bf16["class_embedding"], bf16["positional_embedding"][0],
                                     self._ln_pre["scale"], self._ln_pre["bias"])

    def _calibration_crops(self, images) -> torch.Tensor:
        """The first 32 images as f32 center crops at the model resolution,
        CLIP-normalized."""
        imgs = torch.as_tensor(images[:32], dtype=torch.float32).to(self.device)
        res = self.cfg.image_resolution
        h, w = imgs.shape[-2:]
        top, left = (h - res) // 2, (w - res) // 2
        imgs = imgs[:, :, top : top + res, left : left + res]
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=self.device).reshape(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD, dtype=torch.float32, device=self.device).reshape(1, 3, 1, 1)
        return (imgs - mean) / std

    def sample_geometry(self, generator: torch.Generator, batch: int, src_hw):
        """(cy, cx, inv) for the center view plus ``n_views`` random views."""
        return sample_view_centers(generator, batch, self.n_views + 1, tuple(src_hw),
                                   self.cfg.image_resolution, self.crop_scale)

    def _view_features(self, images: torch.Tensor, geometry) -> torch.Tensor:
        """Source images [B, 3, H, W] in [0, 1] and geometry (cy, cx, inv)
        -> L2-normalized per-view features [B, N, D] f32."""
        cfg = self.cfg
        cy, cx, inv = geometry
        b, n = cy.shape[:2]
        p, res = cfg.vision_patch_size, cfg.image_resolution
        images = images.to(self.device, self.dtype)
        if self.quant is None:
            if self.dtype == torch.float32:
                require_f32_products(self.device, "the f32 engine")
            views = fused_views_nchw(images, cy, cx, inv, res)
            # the patch embedding as the reference's conv: operands in the
            # compute dtype, f32 accumulation, the folded bias in f32
            cols = _patchify(views.reshape(b * n, 3, res, res), p).float()
            tokens = torch.matmul(cols, self._w_embed.float().T) + self._b_embed
            feats = encode_image_tokens(self._params, cfg, tokens, dtype=self.dtype)
        else:
            views = fused_views_nchw(images, cy, cx, inv, res, quantize=True)
            # im2col: patch rows [B' * G², 3 * p * p] in the weight's (c, py, px) order
            cols = _patchify(views.reshape(b * n, 3, res, res), p).reshape(-1, 3 * p * p)
            acc = int8_gemm_s32(cols.contiguous(), self._k_q)
            g = cfg.grid_size
            if cfg.vision_seq_len >= BLOCKED_MIN_SEQ:
                tokens = (acc.float() * self._k_scale + self._k_bias).reshape(b * n, g * g, -1)
                feats = encode_image_tokens(self._params, cfg, tokens, dtype=self.dtype,
                                            quant=self._quant)
            else:
                rows = assemble_dense_rows(
                    acc.reshape(b * n, g, g, -1), self._k_scale, self._k_bias, self._pos_tail,
                    self._cls_row, self._ln_pre["scale"], self._ln_pre["bias"],
                )
                cls_rows = run_fused_tower(rows, self._quant, cfg.vision_heads,
                                           flat_s=cfg.vision_seq_len)
                feats = encode_cls_tail(self._params, cls_rows)
        return l2_normalize(feats).float().reshape(b, n, -1)

    def features_from_images(self, images: torch.Tensor, text_weights: torch.Tensor, *,
                             generator: Optional[torch.Generator] = None,
                             geometry=None) -> torch.Tensor:
        """images [B, 3, H, W] in [0, 1] -> MTA mode features [B, D] f32.

        The crop geometry comes from ``geometry=(cy, cx, inv)`` or is drawn
        with ``generator`` (a ``torch.Generator`` on the engine's device)."""
        if geometry is None:
            if generator is None:
                raise ValueError("pass a generator or the crop geometry")
            geometry = self.sample_geometry(generator, images.shape[0], images.shape[2:])
        geometry = tuple(t.to(self.device) for t in geometry)
        feats = self._view_features(images, geometry)
        return solve_mta_batch(feats, text_weights.to(self.device).float())

    def crop_features(self, crops) -> torch.Tensor:
        """crops [B, N, 3, res, res], CLIP-normalized f32 (row 0 the center
        view) -> per-view L2-normalized features [B, N, D] f32."""
        crops = torch.as_tensor(crops).to(self.device)
        if self.quant is None and self.dtype == torch.float32:
            require_f32_products(self.device, "the f32 engine")
        b, n = crops.shape[:2]
        feats = encode_image(self._params, self.cfg, crops.reshape(b * n, *crops.shape[2:]),
                             dtype=self.dtype, quant=self._quant)
        return l2_normalize(feats).float().reshape(b, n, -1)

    def mta_from_features(self, feats: torch.Tensor, text_weights: torch.Tensor) -> torch.Tensor:
        """Per-view features [B, N, D] -> MTA mode features [B, D] f32: a
        crop cloud encoded once can be solved against several
        classifiers."""
        return solve_mta_batch(torch.as_tensor(feats).to(self.device).float(),
                               torch.as_tensor(text_weights).to(self.device).float())

    def features_from_crops(self, crops, text_weights) -> torch.Tensor:
        """crops [B, N, 3, res, res] -> MTA mode features [B, D] f32;
        ``mta_from_features(crop_features(crops), text_weights)``."""
        return self.mta_from_features(self.crop_features(crops), text_weights)

    def logits(self, modes: torch.Tensor, text_weights: torch.Tensor) -> torch.Tensor:
        """100 x modes [B, D] . text_weights [C, D]^T in f32 (a bf16
        classifier promoted, as JAX promotes it)."""
        return (modes.float() @ text_weights.to(modes.device).float().T) * 100.0
