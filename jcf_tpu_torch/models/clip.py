"""CLIP pieces of ``jcf_tpu/models/clip.py`` in PyTorch: the ViT pieces
of the serving path, the text tower (``encode_text``, float or int8) and
the composable towers (``encode_image``, ``encode_image_tokens``,
``encode_text`` with a LoRA context) of LoRA training and of serving from
128 tokens on, whose attention is K7 below 128 tokens and K8 from 128 on
(``ops.attention.multi_head_attention``).

Parameters are plain nested dicts of tensors with the JAX tree's keys and
layouts: transformer blocks stacked on a leading layer axis, packed
``w_qkv [L, 3E, E]``, ``[out, in]`` linears, ``proj [E, D]``.
``init_clip_params`` draws the same numpy values in the same order as the
JAX package, so a seed gives the same weights on a host without JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from jcf_tpu_torch.ops.attention import causal_mask, multi_head_attention, packed_attention_plain
from jcf_tpu_torch.ops.block_kernel import run_float_tower, run_fused_tower
from jcf_tpu_torch.ops.layers import layer_norm, layer_slice, linear, mlp, quick_gelu

# CLIP pixel statistics (jcf_tpu/data/transforms.py CLIP_MEAN / CLIP_STD)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision tower
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    # IVLP prompting (0 = vanilla CLIP)
    vision_prompt_tokens: int = 0
    vision_prompt_depth: int = 0
    text_prompt_tokens: int = 4
    text_prompt_depth: int = 0

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def vision_seq_len(self) -> int:
        return self.grid_size**2 + 1 + self.vision_prompt_tokens


VIT_B_32 = CLIPConfig()


# ---------------------------------------------------------------------------
# initialization: the JAX package's numpy draws, in its order
# ---------------------------------------------------------------------------


def _init_blocks(rng: np.random.Generator, layers: int, width: int) -> dict:
    proj_std = (width**-0.5) * ((2 * layers) ** -0.5)
    attn_std = width**-0.5
    fc_std = (2 * width) ** -0.5

    def norm(shape, std):
        return torch.from_numpy(rng.normal(0.0, std, size=shape).astype(np.float32))

    L, W = layers, width
    return {
        "ln_1": {"scale": torch.ones(L, W), "bias": torch.zeros(L, W)},
        "attn": {
            "w_qkv": norm((L, 3 * W, W), attn_std),
            "b_qkv": torch.zeros(L, 3 * W),
            "w_out": norm((L, W, W), proj_std),
            "b_out": torch.zeros(L, W),
        },
        "ln_2": {"scale": torch.ones(L, W), "bias": torch.zeros(L, W)},
        "mlp": {
            "c_fc": {"w": norm((L, 4 * W, W), fc_std), "b": torch.zeros(L, 4 * W)},
            "c_proj": {"w": norm((L, W, 4 * W), proj_std), "b": torch.zeros(L, W)},
        },
    }


def init_clip_params(seed: int, cfg: CLIPConfig) -> dict:
    """Random-init CLIP params, value-identical to
    ``jcf_tpu.models.clip.init_clip_params(seed, cfg)`` (CPU f32 tensors)."""
    rng = np.random.default_rng(seed)
    w, tw = cfg.vision_width, cfg.text_width
    scale = w**-0.5

    def norm(shape, std):
        return torch.from_numpy(rng.normal(0.0, std, size=shape).astype(np.float32))

    visual = {
        "patch_embed": {"w": norm((w, 3 * cfg.vision_patch_size**2), scale)},
        "class_embedding": norm((w,), scale),
        "positional_embedding": norm((cfg.grid_size**2 + 1, w), scale),
        "ln_pre": {"scale": torch.ones(w), "bias": torch.zeros(w)},
        "blocks": _init_blocks(rng, cfg.vision_layers, w),
        "ln_post": {"scale": torch.ones(w), "bias": torch.zeros(w)},
        "proj": norm((w, cfg.embed_dim), scale),
    }
    if cfg.vision_prompt_tokens:
        visual["vpt"] = norm((cfg.vision_prompt_tokens, w), 0.02)
    if cfg.vision_prompt_depth > 1:
        visual["vpt_deep"] = norm(
            (cfg.vision_prompt_depth - 1, cfg.vision_prompt_tokens, w), 0.02
        )

    text = {
        "token_embedding": norm((cfg.vocab_size, tw), 0.02),
        "positional_embedding": norm((cfg.context_length, tw), 0.01),
        "blocks": _init_blocks(rng, cfg.text_layers, tw),
        "ln_final": {"scale": torch.ones(tw), "bias": torch.zeros(tw)},
        "text_projection": norm((tw, cfg.embed_dim), tw**-0.5),
    }
    if cfg.text_prompt_depth > 1:
        text["ctx_deep"] = norm(
            (cfg.text_prompt_depth - 1, cfg.text_prompt_tokens, tw), 0.02
        )

    return {
        "visual": visual,
        "text": text,
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32),
    }


def params_from_numpy(tree) -> dict:
    """A param tree of numpy arrays (e.g. the JAX tree after
    ``jax.tree_util.tree_map(np.asarray, params)``) -> the same tree of
    CPU tensors, values and dtypes unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def tree_to(tree, device, dtype=None):
    """A param or quant tree with every tensor moved to ``device`` and,
    given a ``dtype``, its floating tensors cast to it (no copy where
    nothing changes). Dicts and ``QuantizedLinear`` tuples are walked;
    leaves that are not tensors are kept."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(tree_to(v, device, dtype) for v in tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree.to(device, dtype if dtype is not None and tree.is_floating_point() else None)


# ---------------------------------------------------------------------------
# plain f32 forward pieces
# ---------------------------------------------------------------------------


def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, gh*gw, 3*p*p] with (c, ph, pw) pixel order,
    matching the Conv2d weight layout [width, 3, p, p] flattened."""
    b, c, h, w_ = images.shape
    gh, gw = h // patch, w_ // patch
    x = images.reshape(b, c, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * patch * patch)


def _run_blocks(x: torch.Tensor, blocks: dict, n_heads: int, mask: Optional[torch.Tensor], *,
                lora_ctx: Optional[dict] = None, quant: Optional[dict] = None) -> torch.Tensor:
    """The stacked residual blocks over [B, S, E] activations (``jcf_tpu``'s
    ``_run_blocks``).

    Below 128 tokens without a LoRA context the JAX function's fused gate
    (``jcf_tpu/models/clip.py:209-222``, on its chip) takes the fused
    tower on every device (on the CPU through the plain versions), causal
    when ``mask`` is given (the only mask here is the causal one): with a
    quant tree, folded or unfolded, ``ops.block_kernel.run_fused_tower``
    on the flat rows with every row returned (the int8 halves, K3 / K4;
    the unfolded tree's LN affine from ``blocks``); without one the
    unquantized ``run_float_tower`` (K6a / K6b, bf16 or f32).

    Otherwise the composable route: per layer ``x + mha(LN1 x)``, then
    ``x + mlp(LN2 x)``, in x's dtype. With ``lora_ctx``
    (``peft.lora.make_lora_context``) the layers its gates select add the
    decomposed LoRA branch; the others are unchanged (their branch would
    add zeros). With ``quant`` (the unfolded tree of
    ``ops.quant.quantize_clip_params``, stacked like ``blocks``) every
    projection is a dynamic per-row int8 linear. A folded tree is
    serving-only and raises there."""
    b, s, e = x.shape
    if lora_ctx is None and s < 128:
        causal = mask is not None
        if quant is not None:
            rows = run_fused_tower(x.reshape(b * s, e), quant, n_heads, flat_s=s, cls_only=False,
                                   blocks=blocks, causal=causal)
        else:
            rows = run_float_tower(x.reshape(b * s, e), blocks, n_heads, s=s, causal=causal)
        return rows.reshape(b, s, e)
    if quant is not None and quant.get("quant_folded", False):
        raise ValueError("folded int8 trees are serving-only (the fused tower below 128 tokens, "
                         "no LoRA); the composable path needs an unfolded "
                         "quantize_clip_params(fold=False) tree")
    for i in range(blocks["attn"]["w_qkv"].shape[0]):
        layer = layer_slice(blocks, i)
        q_layer = layer_slice(quant, i) if quant is not None else {"attn": None, "mlp": None}
        lora = None
        if lora_ctx is not None and lora_ctx["gates"][i]:
            lora = {"layer": {k: t[i] for k, t in lora_ctx["stacked"].items()},
                    "gate": float(lora_ctx["gates"][i]), "proj_mask": lora_ctx["proj_mask"],
                    "spec": lora_ctx["spec"], "generator": lora_ctx["generator"]}
        x = x + multi_head_attention(
            layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"]),
            layer["attn"], n_heads, mask, lora=lora, quant=q_layer["attn"],
        )
        x = x + mlp(layer_norm(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"]), layer["mlp"],
                    quant=q_layer["mlp"])
    return x


def encode_image(params: dict, cfg: CLIPConfig, images: torch.Tensor, *,
                 dtype: torch.dtype = torch.float32, lora_ctx: Optional[dict] = None,
                 quant: Optional[dict] = None) -> torch.Tensor:
    """Image features [B, embed_dim] (before normalization) from NCHW
    images [B, 3, res, res], in ``dtype``: patchify, the patch embedding
    with the weight cast to ``dtype``, then ``encode_image_tokens``. Runs
    where ``images`` and ``params`` lie."""
    v = params["visual"]
    x = linear(_patchify(images.to(dtype), cfg.vision_patch_size), v["patch_embed"]["w"].to(dtype))
    return encode_image_tokens(params, cfg, x, dtype=dtype, lora_ctx=lora_ctx, quant=quant)


def encode_image_tokens(params: dict, cfg: CLIPConfig, x: torch.Tensor, *,
                        dtype: torch.dtype = torch.float32, lora_ctx: Optional[dict] = None,
                        quant: Optional[dict] = None) -> torch.Tensor:
    """Composable vision tower from embedded patch tokens [B, G², W], in
    ``dtype``: CLS prepend, positional add, the visual prompt tokens
    appended (``vpt``), ln_pre, the residual blocks, ln_post on the CLS
    row, proj. The blocks are ``_run_blocks``'s: below 128 tokens without
    a LoRA context the fused tower, unquantized (K6a, K6b) or with the
    ``quant`` tree (K3, K4; the unfolded tree's dynamic scales, or the
    folded tree's); with the LoRA branch (``lora_ctx``), or from 128
    tokens on with the unfolded tree (dynamic int8 projections), the
    composable tower, whose attention is K7 below 128 tokens and K8 from
    128 on. In f32 it is the reference the int8 path is certified
    against."""
    v = params["visual"]
    if "vpt_deep" in v:
        raise NotImplementedError("deep visual prompts are not ported")
    x = x.to(dtype)
    cls = v["class_embedding"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].to(dtype)
    if cfg.vision_prompt_tokens and "vpt" in v:
        vpt = v["vpt"].to(dtype).expand(x.shape[0], cfg.vision_prompt_tokens, x.shape[-1])
        x = torch.cat([x, vpt], dim=1)
    x = layer_norm(x, v["ln_pre"]["scale"], v["ln_pre"]["bias"])
    x = _run_blocks(x, v["blocks"], cfg.vision_heads, None, lora_ctx=lora_ctx, quant=quant)
    return encode_cls_tail(params, x[:, 0])


def encode_cls_tail(params: dict, cls_rows: torch.Tensor) -> torch.Tensor:
    """Tail of ``encode_image_rows_dense``: ln_post on the CLS rows (output
    in their dtype), then ``proj`` with f32 accumulation, cast back."""
    v = params["visual"]
    dt = cls_rows.dtype
    cls = layer_norm(cls_rows, v["ln_post"]["scale"], v["ln_post"]["bias"])
    return torch.matmul(cls.float(), v["proj"].to(dt).float()).to(dt)


def encode_text_embeddings(params: dict, cfg: CLIPConfig, embeddings: torch.Tensor,
                           eot_positions: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                           lora_ctx: Optional[dict] = None,
                           quant: Optional[dict] = None) -> torch.Tensor:
    """Text features [B, embed_dim] in ``dtype`` (f32 by default, as the
    JAX package) from token embeddings [B, S, tw]: embeddings + positions
    in ``dtype``, the causal tower, ``ln_final`` on the EOT rows (scale in
    f32, output in ``dtype``; the LayerNorm is per row, so gathering first
    changes nothing), then ``text_projection`` cast to ``dtype`` with an
    f32 product, cast back. Runs where ``embeddings`` lie.

    Without ``lora_ctx`` the tower is the causal fused route of
    ``_run_blocks`` in ``dtype`` (bf16 or f32): K6a/K6b, or with ``quant``
    (``quantize_clip_params(params)["text"]``) the int8 halves K3/K4 with
    the masked attention. With ``lora_ctx``, the composable route of LoRA
    training in ``dtype``: K7 with the causal mask and the decomposed LoRA
    branch (and int8 linears with an unfolded ``quant``)."""
    t = params["text"]
    if "ctx_deep" in t:
        raise NotImplementedError("deep text prompts are not ported")
    b, s, _ = embeddings.shape
    x = embeddings.to(dtype) + t["positional_embedding"].to(dtype)
    x = _run_blocks(x, t["blocks"], cfg.text_heads, causal_mask(s, x.device), lora_ctx=lora_ctx,
                    quant=quant)
    x = x[torch.arange(b, device=x.device), eot_positions]
    x = layer_norm(x, t["ln_final"]["scale"], t["ln_final"]["bias"])
    return torch.matmul(x.float(), t["text_projection"].to(dtype).float()).to(dtype)


def encode_text(params: dict, cfg: CLIPConfig, token_ids, *, device="cuda",
                dtype: torch.dtype = torch.float32, lora_ctx: Optional[dict] = None,
                quant: Optional[dict] = None) -> torch.Tensor:
    """Text features [B, embed_dim] from token ids [B, context] (a tensor
    or numpy array), on ``device`` (``jcf_tpu`` ``encode_text``; without
    ``lora_ctx`` its fused route in ``dtype``, f32 by default; int8 with
    ``quant``, the text tree of ``ops.quant.quantize_clip_params``): the
    f32 token table gathered, the EOT position at the argmax of the ids
    (EOT is the largest id). The text params and ``quant`` move to
    ``device`` unless they lie there already."""
    text = tree_to(params["text"], device)
    ids = torch.as_tensor(token_ids).to(device).long()
    return encode_text_embeddings({"text": text}, cfg, text["token_embedding"][ids],
                                  ids.argmax(dim=-1), dtype=dtype, lora_ctx=lora_ctx,
                                  quant=tree_to(quant, device) if quant is not None else None)


def vision_ln_z_amax(params: dict, cfg: CLIPConfig, images: torch.Tensor, *,
                     with_scores: bool = False) -> torch.Tensor:
    """Per-layer activation amax of the vision tower over calibration crops
    [B, 3, res, res] -> [L, 4] f32: z-normalized LN1 input, z-normalized
    LN2 input, attention context, post-QuickGELU hidden. ``with_scores``
    appends the amax of the scaled scores q.k / sqrt(d) and the least row
    max of those scores -> [L, 6], the calibration of the max-free softmax
    shift (``ops.quant.quantize_clip_params``, "score"). Plain f32 forward
    (``jcf_tpu`` ``vision_ln_z_amax``)."""
    v = params["visual"]
    x = linear(_patchify(images.float(), cfg.vision_patch_size),
               v["patch_embed"]["w"].float())
    cls = v["class_embedding"].float().expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].float()
    x = layer_norm(x, v["ln_pre"]["scale"], v["ln_pre"]["bias"])

    def z_amax(t):
        mu = t.mean(dim=-1, keepdim=True)
        var = (t - mu).square().mean(dim=-1, keepdim=True)
        return ((t - mu) * torch.rsqrt(var + 1e-5)).abs().max()

    blocks = v["blocks"]
    n_heads = cfg.vision_heads
    head_dim = cfg.vision_width // n_heads
    rows = []
    for i in range(blocks["attn"]["w_qkv"].shape[0]):
        layer = layer_slice(blocks, i)
        a1 = z_amax(x)
        h1 = layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"])
        qkv = linear(h1, layer["attn"]["w_qkv"], layer["attn"]["b_qkv"])
        cols = []
        if with_scores:
            b, s, _ = qkv.shape
            q, k = qkv[..., : 2 * cfg.vision_width].reshape(b, s, 2, n_heads, head_dim).unbind(2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / qkv.new_tensor(math.sqrt(head_dim))
            # the weakest row's max bounds how far above any row a shift may sit
            cols = [sc.abs().max(), sc.amax(dim=-1).min()]
        # the plain attention, as the JAX function's impl="xla"
        ctx = packed_attention_plain(qkv, n_heads)
        a_ctx = ctx.abs().max()
        x = x + (torch.matmul(ctx, layer["attn"]["w_out"].T) + layer["attn"]["b_out"])
        a2 = z_amax(x)
        h = layer_norm(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"])
        hidden = quick_gelu(torch.matmul(h, layer["mlp"]["c_fc"]["w"].T)
                            + layer["mlp"]["c_fc"]["b"])
        a_h = hidden.abs().max()
        x = x + (torch.matmul(hidden, layer["mlp"]["c_proj"]["w"].T)
                 + layer["mlp"]["c_proj"]["b"])
        rows.append(torch.stack([a1, a2, a_ctx, a_h, *cols]))
    return torch.stack(rows)


def fold_normalize_into_embed(w, mean, std, patch: int):
    """Fold the per-channel CLIP normalization into the patch embedding
    (numpy f32, as the JAX package computes it):
    ``W'_j = W_j / std_c(j)``, ``bias = -sum_j W_j * mean_c(j) / std_c(j)``.
    Returns (w4 [C, p, p, E] f32 tensor, bias [E] f32 tensor)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w_np = np.asarray(w, np.float32)
    pp = patch * patch
    chan = np.repeat(np.arange(w_np.shape[1] // pp), pp)
    mean = np.asarray(mean, np.float32)[chan]
    std = np.asarray(std, np.float32)[chan]
    w_fold = w_np / std[None, :]
    bias = -(w_np * (mean / std)[None, :]).sum(axis=1)
    w4 = w_fold.T.reshape(-1, patch, patch, w_np.shape[0])
    return torch.from_numpy(np.ascontiguousarray(w4)), torch.from_numpy(bias)
