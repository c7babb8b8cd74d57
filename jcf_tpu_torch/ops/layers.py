"""Primitive layers (``jcf_tpu/ops/layers.py``) in plain PyTorch.

Same numeric contract: LayerNorm with eps 1e-5, statistics in f32 and the
output in the input dtype; torch-layout linears (weight ``[out, in]``)
with f32 accumulation; QuickGELU ``x * sigmoid(1.702 x)``.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-5


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis; statistics in f32, output in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W.T + b with W [out, in]. The weight is cast to x.dtype and
    the product accumulates in f32 (bf16 products are exact in f32), then
    the result is cast back to x.dtype before the bias add, as in JAX."""
    w = weight.to(x.dtype)
    y = torch.matmul(x.float(), w.float().T).to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def mlp(x: torch.Tensor, params: dict) -> torch.Tensor:
    """CLIP MLP block: c_fc (d -> 4d) -> QuickGELU -> c_proj (4d -> d)."""
    h = quick_gelu(linear(x, params["c_fc"]["w"], params["c_fc"]["b"]))
    return linear(h, params["c_proj"]["w"], params["c_proj"]["b"])


def layer_slice(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on a leading layer
    axis (dicts and ``QuantizedLinear`` tuples are walked)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(layer_slice(v, i) for v in tree))
    return tree[i]


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x||_2 along ``dim``, computed in f32, returned in x.dtype."""
    x32 = x.float()
    norm = x32.square().sum(dim=dim, keepdim=True).sqrt()
    return (x32 / norm).to(x.dtype)
