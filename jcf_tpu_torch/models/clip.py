"""CLIP ViT pieces of ``jcf_tpu/models/clip.py`` in PyTorch.

Parameters are plain nested dicts of tensors with the JAX tree's keys and
layouts: transformer blocks stacked on a leading layer axis, packed
``w_qkv [L, 3E, E]``, ``[out, in]`` linears, ``proj [E, D]``.
``init_clip_params`` draws the same numpy values in the same order as the
JAX package, so a seed gives the same weights on a host without JAX.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from jcf_tpu_torch.ops.attention import multi_head_attention
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


def encode_image_tokens(params: dict, cfg: CLIPConfig, x: torch.Tensor) -> torch.Tensor:
    """Composable vision tower from embedded patch tokens [B, G², W]:
    CLS prepend, positional add, ln_pre, the residual blocks, ln_post on
    the CLS row, proj. Runs in x.dtype; this is the plain f32 reference
    tower the int8 path is certified against."""
    v = params["visual"]
    dt = x.dtype
    cls = v["class_embedding"].to(dt).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].to(dt)
    x = layer_norm(x, v["ln_pre"]["scale"], v["ln_pre"]["bias"])
    blocks = v["blocks"]
    for i in range(blocks["attn"]["w_qkv"].shape[0]):
        layer = layer_slice(blocks, i)
        x = x + multi_head_attention(
            layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"]),
            layer["attn"], cfg.vision_heads,
        )
        x = x + mlp(
            layer_norm(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"]),
            layer["mlp"],
        )
    return encode_cls_tail(params, x[:, 0])


def encode_cls_tail(params: dict, cls_rows: torch.Tensor) -> torch.Tensor:
    """Tail of ``encode_image_rows_dense``: ln_post on the CLS rows (output
    in their dtype), then ``proj`` with f32 accumulation, cast back."""
    v = params["visual"]
    dt = cls_rows.dtype
    cls = layer_norm(cls_rows, v["ln_post"]["scale"], v["ln_post"]["bias"])
    return torch.matmul(cls.float(), v["proj"].to(dt).float()).to(dt)


def vision_ln_z_amax(params: dict, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """Per-layer activation amax of the vision tower over calibration crops
    [B, 3, res, res] -> [L, 4] f32: z-normalized LN1 input, z-normalized
    LN2 input, attention context, post-QuickGELU hidden. Plain f32
    forward (``jcf_tpu`` ``vision_ln_z_amax`` without ``with_scores``)."""
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
    rows = []
    for i in range(blocks["attn"]["w_qkv"].shape[0]):
        layer = layer_slice(blocks, i)
        a1 = z_amax(x)
        h1 = layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"])
        ctx = multi_head_attention(h1, layer["attn"], cfg.vision_heads,
                                   return_pre_proj=True)
        a_ctx = ctx.abs().max()
        x = x + (torch.matmul(ctx, layer["attn"]["w_out"].T) + layer["attn"]["b_out"])
        a2 = z_amax(x)
        h = layer_norm(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"])
        hidden = quick_gelu(torch.matmul(h, layer["mlp"]["c_fc"]["w"].T)
                            + layer["mlp"]["c_fc"]["b"])
        a_h = hidden.abs().max()
        x = x + (torch.matmul(hidden, layer["mlp"]["c_proj"]["w"].T)
                 + layer["mlp"]["c_proj"]["b"])
        rows.append(torch.stack([a1, a2, a_ctx, a_h]))
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
