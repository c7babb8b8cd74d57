"""TTA serving engine (``jcf_tpu/infer/engine.py``), int8 serving slice.

``TTAEngine.features_from_images`` runs the path ``bench.py`` times on a
TPU, in the configuration it ships there (with the last layer's attention
on all rows, ``_CLS_ATTNQ = False``):

  source images [B, 3, H, W] bf16 + crop geometry (center + random views)
  -> K1 int8 views [B, N, 3, 224, 224]          (ops.view_kernel)
  -> im2col (a permute) + int8 GEMM -> int32    (ops.int8_gemm)
  -> K2 flat bf16 rows [B' * S, E]              (ops.assemble_kernel)
  -> int8 tower, K3/K4 per layer -> CLS rows    (ops.block_kernel)
  -> ln_post, proj, L2 norm -> MTA modes [B, D] (models.clip, tta.mta)

``quant=None`` builds the plain f32 reference of the same function: f32
views, f32 patch embed, the composable f32 tower. The int8 path is
certified against it (top-1 agreement, top-5 overlap), as ``bench.py``
certifies the JAX int8 engine.

The engine runs on one ``device``. Calibration runs the f32 tower on a
CUDA device, so full-f32 matmuls (``torch.backends.cuda.matmul.allow_tf32
= False``) are required there.
"""

from __future__ import annotations

from typing import Optional

import torch

from jcf_tpu_torch.models.clip import (
    CLIP_MEAN,
    CLIP_STD,
    CLIPConfig,
    _patchify,
    encode_cls_tail,
    encode_image_tokens,
    fold_normalize_into_embed,
    vision_ln_z_amax,
)
from jcf_tpu_torch.ops.assemble_kernel import assemble_dense_rows, make_cls_row
from jcf_tpu_torch.ops.block_kernel import run_fused_tower
from jcf_tpu_torch.ops.int8_gemm import int8_gemm_s32
from jcf_tpu_torch.ops.layers import l2_normalize
from jcf_tpu_torch.ops.quant import quantize_clip_params
from jcf_tpu_torch.ops.view_kernel import (
    fused_views_nchw,
    fused_views_nchw_plain,
    sample_view_centers,
)
from jcf_tpu_torch.tta.mta import solve_mta_batch


def _embed_quant(w4f: torch.Tensor, fb: torch.Tensor):
    """int8 patch embed from the normalization-folded f32 weight
    w4f [C, p, p, E] and bias fb [E]: per-channel int8 weight [E, C*p*p],
    dequant scale kscale / 254, and bias fb + rowsum(W) * 127/254 (the
    view kernel's +127 pixel offset, folded)."""
    flat = w4f.permute(3, 0, 1, 2).reshape(w4f.shape[3], -1)  # [E, C*p*p]
    kscale = torch.clamp_min(flat.abs().amax(dim=1) / 127.0, 1e-8)
    k_q = torch.clamp(torch.round(flat / kscale[:, None]), -127, 127).to(torch.int8).contiguous()
    bias_i8 = fb + flat.sum(dim=1) * (127.0 / 254.0)
    return k_q, kscale / 254.0, bias_i8


class TTAEngine:
    """Images -> MTA mode features / logits on one device.

    params: the CLIP param tree (f32 CPU tensors, ``models.clip`` layout).
    quant: "int8" (the serving slice; needs ``calibration_images``) or None
    (the plain f32 reference).
    """

    def __init__(self, params: dict, cfg: CLIPConfig, *, device="cpu", n_views: int = 8,
                 quant: Optional[str] = "int8", calibration_images=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_views = n_views  # random views per image; the center view is added
        self.quant = quant
        dev = self.device
        v = params["visual"]
        w4, fold_bias = fold_normalize_into_embed(
            v["patch_embed"]["w"], CLIP_MEAN, CLIP_STD, cfg.vision_patch_size
        )
        if quant is None:
            self.dtype = torch.float32
            self._params = {"visual": _to(v, dev)}
            self._w_embed = w4.permute(3, 0, 1, 2).reshape(w4.shape[3], -1).to(dev)
            self._b_embed = fold_bias.to(dev)
            return
        if quant != "int8":
            raise ValueError(f"unknown quant mode {quant!r}")
        if calibration_images is None:
            raise NotImplementedError("dynamic activation quantization is not ported")
        self.dtype = torch.bfloat16
        if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("calibration needs full f32 matmuls: set "
                               "torch.backends.cuda.matmul.allow_tf32 = False")
        params_dev = {"visual": _to(v, dev)}
        amax = vision_ln_z_amax(params_dev, cfg, self._calibration_crops(calibration_images))
        self._quant = quantize_clip_params(
            params_dev, heads={"visual": cfg.vision_heads}, act_scales={"visual": amax},
        )["visual"]
        self._k_q, self._k_scale, self._k_bias = _embed_quant(w4.to(dev), fold_bias.to(dev))
        bf = torch.bfloat16
        pos = v["positional_embedding"].to(dev, bf)
        ln_pre = {k: t.to(dev, bf) for k, t in v["ln_pre"].items()}
        self._pos_tail = pos[1:].contiguous()
        self._ln_pre = ln_pre
        self._cls_row = make_cls_row(v["class_embedding"].to(dev, bf), pos[0],
                                     ln_pre["scale"], ln_pre["bias"])
        # the tail reads bf16 copies, as the JAX engine casts its params
        self._params = {"visual": {"ln_post": {k: t.to(dev, bf) for k, t in v["ln_post"].items()},
                                   "proj": v["proj"].to(dev, bf)}}

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
                                   self.cfg.image_resolution)

    def _view_features(self, images: torch.Tensor, geometry) -> torch.Tensor:
        """Source images [B, 3, H, W] in [0, 1] and geometry (cy, cx, inv)
        -> L2-normalized per-view features [B, N, D] f32."""
        cfg = self.cfg
        cy, cx, inv = geometry
        b, n = cy.shape[:2]
        p, res = cfg.vision_patch_size, cfg.image_resolution
        images = images.to(self.device, self.dtype)
        if self.quant is None:
            views = fused_views_nchw_plain(images, cy, cx, inv, res)
            tokens = torch.matmul(_patchify(views.reshape(b * n, 3, res, res), p),
                                  self._w_embed.T) + self._b_embed
            feats = encode_image_tokens(self._params, cfg, tokens)
        else:
            views = fused_views_nchw(images, cy, cx, inv, res)
            # im2col: patch rows [B' * 49, 3 * p * p] in the weight's (c, py, px) order
            cols = _patchify(views.reshape(b * n, 3, res, res), p).reshape(-1, 3 * p * p)
            acc = int8_gemm_s32(cols.contiguous(), self._k_q)
            g = cfg.grid_size
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

    def logits(self, modes: torch.Tensor, text_weights: torch.Tensor) -> torch.Tensor:
        return (modes @ text_weights.T) * 100.0


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
