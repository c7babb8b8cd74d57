"""Primitive layers (``jcf_tpu/ops/layers.py``) in plain PyTorch.

Same numeric contract: LayerNorm with eps 1e-5, statistics in f32 and the
output in the input dtype; torch-layout linears (weight ``[out, in]``)
with f32 accumulation; QuickGELU ``x * sigmoid(1.702 x)``.
"""

from __future__ import annotations

import torch

from jcf_tpu_torch.ops.quant import int8_linear

LN_EPS = 1e-5
# QuickGELU x * sigmoid(1.702 x) == x * (0.5 + 0.5 tanh(0.851 x)), the
# form the reference kernels use
GELU_TANH_COEF = 0.851


def require_f32_products(dev: torch.device, what: str) -> None:
    """Raises on a CUDA device while PyTorch may run f32 products in TF32:
    matmuls (``torch.backends.cuda.matmul.allow_tf32``, off by default) or
    cuDNN's convolutions (``torch.backends.cudnn.allow_tf32``, on by
    default). The JAX package computes them in f32."""
    if dev.type != "cuda":
        return
    for flag, on in (("torch.backends.cuda.matmul.allow_tf32",
                      torch.backends.cuda.matmul.allow_tf32),
                     ("torch.backends.cudnn.allow_tf32", torch.backends.cudnn.allow_tf32)):
        if on:
            raise RuntimeError(f"{what} needs full f32 products: set {flag} = False")


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
    the result is cast back to x.dtype before the bias add, as in JAX. On
    the card a bf16 product is one bf16 ``matmul``, which gives f32
    accumulation and one rounding only while
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    is False; it raises otherwise."""
    w = weight.to(x.dtype)
    if x.is_cuda and x.dtype == torch.bfloat16:
        if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
            raise RuntimeError("a bf16 linear on the card needs torch.backends.cuda.matmul."
                               "allow_bf16_reduced_precision_reduction = False")
        y = torch.matmul(x, w.T)
    else:
        y = torch.matmul(x.float(), w.float().T).to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def mlp(x: torch.Tensor, params: dict, quant: dict | None = None) -> torch.Tensor:
    """CLIP MLP block: c_fc (d -> 4d) -> QuickGELU -> c_proj (4d -> d).
    ``quant``: the layer's unfolded int8 ``{"c_fc", "c_proj"}`` leaves;
    both products then run as dynamic per-row int8 linears."""
    if quant is not None:
        return int8_linear(quick_gelu(int8_linear(x, quant["c_fc"])), quant["c_proj"])
    h = quick_gelu(linear(x, params["c_fc"]["w"], params["c_fc"]["b"]))
    return linear(h, params["c_proj"]["w"], params["c_proj"]["b"])


def layer_slice(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on a leading layer
    axis (dicts and ``QuantizedLinear`` tuples are walked; a leaf that is
    not a tensor, such as a quant tree's ``quant_folded``, is kept)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(layer_slice(v, i) for v in tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree[i]


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x||_2 along ``dim``, computed in f32, returned in x.dtype."""
    x32 = x.float()
    norm = x32.square().sum(dim=dim, keepdim=True).sqrt()
    return (x32 / norm).to(x.dtype)
