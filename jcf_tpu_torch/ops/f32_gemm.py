"""f32 x f32 -> f32 GEMM with fused epilogues (``csrc/f32_gemm.cu``).

``a [M, K]`` f32 activations times ``w [N, K]`` f32 weights (the JAX
``[out, in]`` layout), with an f32 bias, then one of:

- ``f32_gemm_bias``: ``acc + bias`` (qkv projection);
- ``f32_gemm_residual``: ``resid + (acc + bias)`` (out-proj, c_proj);
- ``f32_gemm_gelu``: ``h * (0.5 + 0.5 tanh(0.851 h))``, ``h = acc + bias``
  (c_fc with QuickGELU, ``_quick_gelu32``).

These are the products inside ``jcf_tpu``'s ``_attn_half_kernel`` and
``_mlp_half_kernel`` (K6a, K6b) on the f32 towers, which the TPU runs at
``Precision.HIGHEST`` (several bf16 passes). Each wrapper launches the
CUDA kernel for CUDA tensors and runs its plain version (f32 FMAs,
``torch.matmul``) for CPU tensors.

The kernel runs on the tensor cores, each f32 product as three TF32
products: every operand x is ``hi + lo`` with ``hi = tf32(x)`` and ``lo =
tf32(x - hi)``, rounded to nearest, ties away (``tf32_split_plain``), and
``a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi``. That drops ``a_lo b_lo`` and
the split's remainders, about ``3 2^-22 |a b|`` a product. The tensor
cores' own adds truncate, so each 32-deep stage of K sums into a fresh
partial that joins the tile's sum by an f32 add rounded to nearest. Both
stay inside the f32 bar the kernel is held to against its plain version
(``1e-5 + 1e-5 |ref| + 1e-6 sum_k |a w|``, the bar of f32 sums in another
order). The weights come split: ``with_tf32_planes`` adds each stacked
f32 weight's hi and lo planes beside it once, when a tree is made for
serving (``tf32_split``, a kernel of its own, once a layer and weight),
and the GEMM on the card reads them (``planes=``; without them it
raises). The GEMM splits the activations as it reads them. PyTorch's own
TF32 flags play no part:
``ops.layers.require_f32_products`` still refuses them for the port's
``torch.matmul`` products.

The kernel computes 128 x 128 output tiles, one block an SM, the grid
persistent at every K (``gemm_plan``).
"""

from __future__ import annotations

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops import wgmma_gemm
from jcf_tpu_torch.ops.bf16_gemm import gelu_plain

_EPILOGUES = {"bias": 0, "residual": 1, "gelu": 2}
# launches of the GEMM kernel, by epilogue, and of the weights' split
LAUNCHES = {**{f"f32_gemm_{e}": 0 for e in _EPILOGUES}, "tf32_split": 0}

def gemm_plan(m: int, n: int, sms: int) -> int:
    """The grid over the 128 x 128 output tiles: one block an SM (4 stages
    of 48 KB), persistent at every K (a block a tile would refill its ring
    at each tile)."""
    return min(wgmma_gemm.tiles(m, n), sms)


def tf32_split_plain(w: torch.Tensor) -> torch.Tensor:
    """f32 ``w`` -> ``[2, *w.shape]``: ``hi = tf32(w)``, ``lo = tf32(w -
    hi)``, each rounded to nearest with ties away from zero (the rounding
    of ``cvt.rna.tf32.f32``) on the bits: add half of the 13 dropped bits'
    weight to the magnitude, then clear them (``w - hi`` is exact in
    f32), in 32-bit unsigned arithmetic as the kernel's. A finite value
    past the largest tf32 rounds to infinity."""
    def rna(x):
        bits = (x.contiguous().view(torch.int32).to(torch.int64) + 0x1000) & 0xFFFFE000
        return (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)

    hi = rna(w)
    return torch.stack((hi, rna(w - hi)))


def tf32_split(w: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``tf32_split_plain`` by the split kernel for a CUDA ``w`` (f32,
    contiguous, 16-byte aligned, a multiple of 4 elements), into ``out``
    ([2, *w.shape], contiguous and aligned) where given; the CPU's plain
    version takes no ``out``."""
    if not w.is_cuda:
        if out is not None:
            raise ValueError("tf32_split: out= is for CUDA tensors")
        return tf32_split_plain(w)
    if w.dtype != torch.float32 or not w.is_contiguous() or w.numel() % 4 or w.numel() < 4 \
            or w.data_ptr() % 16:
        raise ValueError(f"tf32_split takes a contiguous, 16-byte aligned f32 tensor of a "
                         f"positive multiple of 4 elements, got {w.dtype} {tuple(w.shape)}")
    if out is None:
        out = torch.empty((2, *w.shape), dtype=torch.float32, device=w.device)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (2, *w.shape) or out.device != w.device
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"tf32_split: out must be contiguous, 16-byte aligned f32 "
                         f"{(2, *w.shape)} on {w.device}")
    lib = _build.load()
    err = lib.jcf_tf32_split(w.data_ptr(), out.data_ptr(), w.numel(), _build.stream_ptr(w.device))
    _build.check(err, "tf32_split")
    LAUNCHES["tf32_split"] += 1
    return out


# the paths of the f32 GEMM weights in a stacked float tree
PLANE_WEIGHTS = (("attn", "w_qkv"), ("attn", "w_out"), ("mlp", "c_fc", "w"), ("mlp", "c_proj", "w"))


def planes_key(name: str) -> str:
    """The key of weight ``name``'s TF32 planes, beside it in its dict."""
    return f"{name}_tf32"


def with_tf32_planes(blocks: dict) -> dict:
    """A stacked float tree's blocks (f32 weights [L, N, K]) -> the same
    dicts with each f32 GEMM weight's TF32 hi and lo planes [L, 2, N, K]
    beside it under ``planes_key`` (``attn.w_qkv_tf32``, ``attn.w_out_tf32``,
    ``mlp.c_fc.w_tf32``, ``mlp.c_proj.w_tf32``): what ``f32_gemm_*`` and
    ``block_f32`` read on the card, split once here and never per call.
    On the card one ``tf32_split`` launch a layer and weight (48 for
    ViT-B/32's towers), on the CPU ``tf32_split_plain``; the planes lie
    where the weights lie. Planes already present are kept; nothing is
    changed in place (the dicts on the weights' paths are copied)."""
    out = dict(blocks)
    for path in PLANE_WEIGHTS:
        parents = [out]
        for key in path[:-1]:
            parents.append(dict(parents[-1][key]))
            parents[-2][key] = parents[-1]
        owner, name = parents[-1], path[-1]
        if planes_key(name) in owner:
            continue
        w = owner[name]
        if w.dtype != torch.float32 or w.dim() != 3:
            raise ValueError(f"with_tf32_planes takes stacked f32 weights [L, N, K], got "
                             f"{'.'.join(path)} {w.dtype} {tuple(w.shape)}")
        if w.is_cuda:
            w = w.contiguous()
            planes = torch.empty((w.shape[0], 2, *w.shape[1:]), dtype=torch.float32,
                                 device=w.device)
            for layer in range(w.shape[0]):
                tf32_split(w[layer], planes[layer])
        else:
            planes = tf32_split_plain(w).transpose(0, 1).contiguous()
        owner[planes_key(name)] = planes
    return out


def need_planes(planes, w, name: str) -> torch.Tensor:
    """The planes of ``w`` [N, K] a CUDA f32 product reads, checked."""
    if planes is None:
        raise ValueError(f"{name} on the card reads the weights' TF32 planes: build the tree with "
                         f"ops.f32_gemm.with_tf32_planes and pass planes=")
    if (planes.dtype != torch.float32 or tuple(planes.shape) != (2, *w.shape)
            or planes.device != w.device or not planes.is_contiguous() or planes.data_ptr() % 16):
        raise ValueError(f"{name}: planes must be contiguous, 16-byte aligned f32 "
                         f"{(2, *w.shape)} on {w.device}, got {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}")
    return planes


def f32_gemm_bias_plain(a, w, bias):
    return torch.matmul(a, w.T) + bias


def f32_gemm_residual_plain(a, w, bias, resid):
    return resid + (torch.matmul(a, w.T) + bias)


def f32_gemm_gelu_plain(a, w, bias):
    return gelu_plain(torch.matmul(a, w.T) + bias)


def _launch(epilogue, a, w, bias, resid=None, planes=None):
    m, k = a.shape
    n = w.shape[0]
    f32 = torch.float32
    if a.dtype != f32 or w.dtype != f32 or w.shape[1] != k:
        raise ValueError(f"f32 GEMM takes f32 a [M, K] and w [N, K], got {a.dtype} "
                         f"{tuple(a.shape)}, {w.dtype} {tuple(w.shape)}")
    if m < 1 or k < 4 or k % 4 or n < 4 or n % 4:
        raise ValueError(f"f32 GEMM needs M >= 1 and K, N positive multiples of 4 (TMA's "
                         f"16-byte rows, the epilogue's column pairs), got M={m}, K={k}, N={n}")
    wgmma_gemm.check_shape(m, n, 4 * k, "f32 GEMM")
    if bias.dtype != f32 or tuple(bias.shape) != (n,) or bias.device != a.device:
        raise ValueError(f"bias must be f32 ({n},) on {a.device}")
    if resid is not None and (resid.dtype != f32 or tuple(resid.shape) != (m, n)
                              or resid.device != a.device):
        raise ValueError(f"resid must be f32 ({m}, {n}) on {a.device}")
    args = [t for t in (a, w, bias, resid) if t is not None]
    if any(not t.is_contiguous() for t in args) or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("f32 GEMM operands must be contiguous, a and w 16-byte aligned "
                         "(TMA's rule)")
    split = need_planes(planes, w, f"f32_gemm_{epilogue}")
    out = torch.empty((m, n), dtype=f32, device=a.device)
    blocks = gemm_plan(m, n, wgmma_gemm.sm_count(a.device.index))
    lib = _build.load()
    err = lib.jcf_f32_gemm(a.data_ptr(), split.data_ptr(), out.data_ptr(), m, n, k,
                           _EPILOGUES[epilogue], bias.data_ptr(),
                           resid.data_ptr() if resid is not None else None, blocks,
                           _build.stream_ptr(a.device))
    _build.check(err, f"f32_gemm_{epilogue}")
    LAUNCHES[f"f32_gemm_{epilogue}"] += 1
    return out


def f32_gemm_bias(a, w, bias, *, planes=None):
    """``planes``: w's TF32 planes [2, N, K] (``with_tf32_planes``), which
    the card reads and the CPU's plain version does not."""
    if not a.is_cuda:
        return f32_gemm_bias_plain(a, w, bias)
    return _launch("bias", a, w, bias, planes=planes)


def f32_gemm_residual(a, w, bias, resid, *, planes=None):
    if not a.is_cuda:
        return f32_gemm_residual_plain(a, w, bias, resid)
    return _launch("residual", a, w, bias, resid, planes)


def f32_gemm_gelu(a, w, bias, *, planes=None):
    if not a.is_cuda:
        return f32_gemm_gelu_plain(a, w, bias)
    return _launch("gelu", a, w, bias, planes=planes)
