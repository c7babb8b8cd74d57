"""LoRA as a parameter-tree transform (``jcf_tpu/peft/lora.py``).

- rank-r factors per attention projection, scaling = alpha / sqrt(r);
- A ~ U(-1/sqrt(W), 1/sqrt(W)) drawn with numpy in the JAX package's
  order, B = 0, so a seed gives the JAX factors;
- factors stacked over layers: ``a_qkv [L, 3, r, W]``, ``b_qkv [L, 3, W, r]``
  (projection order q, k, v) and, with "o" in the params, ``a_out [L, r, W]``
  and ``b_out [L, W, r]``; layers and projections the spec leaves out are
  zeroed by masks, so no gradient flows into them;
- inference merges ``W + scaling * B @ A`` into the packed weights;
  training adds ``scaling * drop(x) @ A^T B^T`` in f32, cast to x's dtype,
  with dropout on the LoRA branch only.

The dropout keep masks come from ``dropout_keep_masks`` and a
``torch.Generator``; they cannot reproduce the bits of ``jax.random``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

# Layer-position tables (``ood.py:27-63`` of the reference)
INDEX_POSITIONS_TEXT = {
    "top1": [11],
    "top2": [10, 11],
    "top3": [9, 10, 11],
    "bottom": [0, 1, 2, 3],
    "mid": [4, 5, 6, 7],
    "up": [8, 9, 10, 11],
    "half-up": [6, 7, 8, 9, 10, 11],
    "half-bottom": [0, 1, 2, 3, 4, 5],
    "all": list(range(12)),
}

INDEX_POSITIONS_VISION = {
    "ViT-B/16": {
        "top": [11],
        "top3": [9, 10, 11],
        "bottom": [0, 1, 2, 3],
        "mid": [4, 5, 6, 7],
        "up": [8, 9, 10, 11],
        "half-up": [6, 7, 8, 9, 10, 11],
        "half-bottom": [0, 1, 2, 3, 4, 5],
        "all": list(range(12)),
    },
    "ViT-B/32": {
        "bottom": [0, 1, 2, 3],
        "mid": [4, 5, 6, 7],
        "up": [8, 9, 10, 11],
        "half-up": [6, 7, 8, 9, 10, 11],
        "half-bottom": [0, 1, 2, 3, 4, 5],
        "all": list(range(12)),
    },
    "ViT-L/14": {
        "bottom": [0, 1, 2, 3],
        "mid": [4, 5, 6, 7],
        "up": [8, 9, 10, 11],
        "half-up": [6, 7, 8, 9, 10, 11],
        "half-bottom": [0, 1, 2, 3, 4, 5],
        "all": list(range(21)),
    },
}

_PROJ_ORDER = ("q", "k", "v")


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    """Static LoRA configuration (the reference's LoRA flags)."""

    r: int = 4
    alpha: float = 1.0
    dropout_rate: float = 0.25
    params: Tuple[str, ...] = ("q", "k", "v")
    encoder: str = "both"  # "text" | "vision" | "both"
    position: str = "all"
    backbone: str = "ViT-B/32"

    @property
    def scaling(self) -> float:
        return self.alpha / math.sqrt(self.r)

    def text_indices(self, n_layers: int):
        if self.encoder not in ("text", "both"):
            return []
        return [i for i in INDEX_POSITIONS_TEXT[self.position] if i < n_layers]

    def vision_indices(self, n_layers: int):
        if self.encoder not in ("vision", "both"):
            return []
        return [i for i in INDEX_POSITIONS_VISION[self.backbone][self.position] if i < n_layers]


def _proj_mask(spec: LoraSpec) -> np.ndarray:
    return np.array([1.0 if p in spec.params else 0.0 for p in _PROJ_ORDER], np.float32)


def lora_layer_masks(spec: LoraSpec, n_text: int, n_vision: int) -> dict:
    """Static (layer, projection) masks as f32 numpy arrays."""
    text = np.zeros((n_text,), np.float32)
    text[spec.text_indices(n_text)] = 1.0
    vision = np.zeros((n_vision,), np.float32)
    vision[spec.vision_indices(n_vision)] = 1.0
    return {"text": text, "vision": vision, "proj": _proj_mask(spec),
            "out": 1.0 if "o" in spec.params else 0.0}


def _init_tower(rng: np.random.Generator, n_layers: int, width: int, spec: LoraSpec) -> dict:
    r = spec.r
    bound = 1.0 / math.sqrt(width)  # kaiming-uniform(a=sqrt(5)) on [r, W]
    a_qkv = rng.uniform(-bound, bound, size=(n_layers, 3, r, width)).astype(np.float32)
    tower = {"a_qkv": torch.from_numpy(a_qkv),
             "b_qkv": torch.zeros((n_layers, 3, width, r), dtype=torch.float32)}
    if "o" in spec.params:
        a_out = rng.uniform(-bound, bound, size=(n_layers, r, width)).astype(np.float32)
        tower["a_out"] = torch.from_numpy(a_out)
        tower["b_out"] = torch.zeros((n_layers, width, r), dtype=torch.float32)
    return tower


def init_lora_params(seed: int, spec: LoraSpec, n_text: int, text_width: int,
                     n_vision: int, vision_width: int) -> dict:
    """Fresh LoRA factors for both towers (CPU f32 tensors), value-identical
    to the JAX package's for the same seed; disabled slices are allocated
    and kept inert by the masks."""
    rng = np.random.default_rng(seed)
    out = {}
    if spec.encoder in ("text", "both"):
        out["text"] = _init_tower(rng, n_text, text_width, spec)
    if spec.encoder in ("vision", "both"):
        out["vision"] = _init_tower(rng, n_vision, vision_width, spec)
    return out


def _merged_qkv_delta(tower: dict, spec: LoraSpec, layer_mask: np.ndarray,
                      proj_mask: np.ndarray) -> torch.Tensor:
    """[L, 3W, W] additive delta for the packed qkv weight."""
    delta = torch.einsum("lpwr,lprv->lpwv", tower["b_qkv"], tower["a_qkv"])
    lm = torch.from_numpy(layer_mask).to(delta.device)
    pm = torch.from_numpy(proj_mask).to(delta.device)
    delta = delta * spec.scaling * lm[:, None, None, None] * pm[None, :, None, None]
    n, _, w, _ = delta.shape
    return delta.reshape(n, 3 * w, w)


def merge_lora_params(params: dict, lora: dict, spec: LoraSpec) -> dict:
    """Inference-time merge: model params with ``W + scaling * B @ A``
    folded into the packed qkv (and output) projection weights. The input
    tree is not modified."""
    masks = lora_layer_masks(spec, params["text"]["blocks"]["attn"]["w_qkv"].shape[0],
                             params["visual"]["blocks"]["attn"]["w_qkv"].shape[0])
    new = dict(params)
    for tower_name, mask_key in (("text", "text"), ("visual", "vision")):
        if mask_key not in lora:
            continue
        tower_lora = lora[mask_key]
        attn = dict(new[tower_name]["blocks"]["attn"])
        attn["w_qkv"] = attn["w_qkv"] + _merged_qkv_delta(tower_lora, spec, masks[mask_key],
                                                          masks["proj"])
        if "a_out" in tower_lora and masks["out"]:
            delta_o = torch.einsum("lwr,lrv->lwv", tower_lora["b_out"], tower_lora["a_out"])
            lm = torch.from_numpy(masks[mask_key]).to(delta_o.device)
            attn["w_out"] = attn["w_out"] + delta_o * spec.scaling * lm[:, None, None]
        new[tower_name] = {**new[tower_name], "blocks": {**new[tower_name]["blocks"], "attn": attn}}
    return new


def dropout_keep_masks(generator: torch.Generator, keep: float, shape, device) -> torch.Tensor:
    """Bernoulli(keep) keep masks of ``shape`` (bool) drawn from
    ``generator``, which lies on ``device``."""
    return torch.rand(shape, generator=generator, device=device) < keep


def lora_qkv_adjustment(x: torch.Tensor, layer_lora: dict, spec: LoraSpec, layer_gate,
                        proj_mask: torch.Tensor,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """Decomposed training-path contribution to the packed qkv output.

    x [B, S, W]; ``layer_lora`` holds this layer's a_qkv [3, r, W] and
    b_qkv [3, W, r]. Independent dropout per projection. Computed in f32,
    returned [B, S, 3W] in x's dtype."""
    b, s, w = x.shape
    if generator is not None and spec.dropout_rate > 0:
        keep = 1.0 - spec.dropout_rate
        masks = dropout_keep_masks(generator, keep, (3,) + tuple(x.shape), x.device)
        xin = torch.where(masks, x[None] / keep, torch.zeros((), dtype=x.dtype, device=x.device))
    else:
        xin = x[None].expand((3,) + tuple(x.shape))
    u = torch.einsum("pbsw,prw->pbsr", xin.float(), layer_lora["a_qkv"])
    d = torch.einsum("pbsr,pwr->pbsw", u, layer_lora["b_qkv"])
    d = d * spec.scaling * layer_gate * proj_mask[:, None, None, None]
    return d.permute(1, 2, 0, 3).reshape(b, s, 3 * w).to(x.dtype)


def lora_out_adjustment(x: torch.Tensor, layer_lora: dict, spec: LoraSpec, layer_gate,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """Decomposed contribution of the output-projection LoRA ('o')."""
    if generator is not None and spec.dropout_rate > 0:
        keep = 1.0 - spec.dropout_rate
        mask = dropout_keep_masks(generator, keep, tuple(x.shape), x.device)
        xin = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
    else:
        xin = x
    u = torch.einsum("bsw,rw->bsr", xin.float(), layer_lora["a_out"])
    d = torch.einsum("bsr,wr->bsw", u, layer_lora["b_out"])
    return (d * spec.scaling * layer_gate).to(x.dtype)


def make_lora_context(lora: dict, spec: LoraSpec, tower: str, n_layers: int,
                      generator: Optional[torch.Generator] = None) -> Optional[dict]:
    """Per-tower context the model's block loop reads: the stacked factors,
    the per-layer gates and projection mask, the spec and the dropout
    generator (None: no dropout). None when LoRA does not apply to the
    tower."""
    if tower not in lora:
        return None
    indices = spec.text_indices(n_layers) if tower == "text" else spec.vision_indices(n_layers)
    if not indices:
        return None
    gates = np.zeros((n_layers,), np.float32)
    gates[indices] = 1.0
    stacked = lora[tower]
    return {
        "stacked": stacked,
        "gates": gates,
        "proj_mask": torch.from_numpy(_proj_mask(spec)).to(stacked["a_qkv"].device),
        "spec": spec,
        "generator": generator,
    }
