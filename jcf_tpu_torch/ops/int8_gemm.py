"""int8 x int8 -> int32 GEMM with fused epilogues (``csrc/int8_gemm.cu``).

``a [M, K]`` int8 activations times ``w [N, K]`` int8 weights (the JAX
``[out, in]`` layout), accumulated exactly in int32, then one of:

- ``int8_gemm_s32``: the raw int32 accumulators (patch embed);
- ``int8_gemm_bf16``: ``bf16(acc * scale + bias)`` (qkv projection);
- ``int8_gemm_residual``: ``resid + (acc * scale + bias)`` with the
  residual add in f32, stored in the residual's dtype (out-proj, c_proj):
  bf16, or f32 for the f32 int8 text tower (``<name>_f32``);
- ``int8_gemm_gelu_quant``: ``int8(round(h * (0.5 + 0.5 tanh(c h))))``,
  ``h = acc * scale + bias`` (c_fc with the static hidden scale folded,
  ``jcf_tpu`` ``_gelu_quant_static``);
- ``int8_gemm_rowscale``: ``bf16((acc * row_scale[m]) * scale[n] +
  bias[n])`` (the dynamic per-row int8 linear, ``ops.quant.int8_linear``);
- ``int8_gemm_f32``: ``acc * scale + bias`` in f32 (c_fc before a
  dynamic hidden quantization).

``int8_gemm_bf16``, ``int8_gemm_residual`` and ``int8_gemm_f32`` take an
optional ``row_scale`` [M], the dynamic per-row scales of the fused
tower's int8 rows, applied in that tower's op order: ``(acc * scale[n])
* row_scale[m] + bias[n]`` (``jcf_tpu`` ``_int8_gemm``), each its own
epilogue (``<name>_rows``).

Each wrapper launches the CUDA kernel for CUDA tensors and runs its plain
version (``<name>_plain``, the same arguments) for CPU tensors. The plain
product runs in float64, which holds every partial sum of int8 products
exactly (|acc| < 2**53).

The kernel (wgmma fed by TMA) computes 128 x ``bn`` output tiles, block b
of a grid of B taking tiles b, b + B, ... (N-fastest); ``gemm_plan`` picks
``bn`` and the grid.
"""

from __future__ import annotations

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops import wgmma_gemm

_EPILOGUES = {"s32": 0, "bf16": 1, "residual": 2, "gelu_quant": 3, "rowscale": 4,
              "bf16_rows": 5, "residual_rows": 6, "f32": 7, "f32_rows": 8, "residual_f32": 9,
              "residual_f32_rows": 10}
# launches of the GEMM kernel, by epilogue
LAUNCHES = {f"int8_gemm_{e}": 0 for e in _EPILOGUES}


# the kernel's row tile (two consumer warpgroups of 64 rows)
BM = wgmma_gemm.BM


def gemm_plan(epilogue: str, m: int, n: int, k: int, sms: int) -> tuple:
    """(bn, blocks): the N tile, 256 (one block an SM) for the raw int32
    product where N is a multiple of 256, else 128 (two blocks an SM: one
    block's epilogue runs beside the other's products); the grid,
    persistent from K 2048 on (``wgmma_gemm.grid``)."""
    bn = 256 if epilogue == "s32" and n % 256 == 0 else 128
    return bn, wgmma_gemm.grid(m, n, bn, sms, 1 if bn == 256 else 2,
                               k >= wgmma_gemm.PERSISTENT_K)


def int8_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ w.T`` for int8 a [M, K], w [N, K]."""
    return torch.matmul(a.double(), w.double().T).to(torch.int32)


def dequant_plain(acc, scale, bias, row_scale=None):
    """``acc * scale + bias`` in f32; with ``row_scale`` [M], ``(acc *
    scale) * row_scale[m] + bias`` (the fused tower's order)."""
    y = acc.float() * scale
    if row_scale is not None:
        y = y * row_scale[:, None]
    return y + bias


def rowscale_plain(acc, row_scale, scale, bias):
    """``(acc * row_scale[m]) * scale[n] + bias[n]`` in f32, in that order."""
    return (acc.float() * row_scale[:, None]) * scale + bias


def gelu_quant_plain(h, c):
    """QuickGELU in tanh form on values already in the quantized domain,
    then round-half-even and saturate to int8."""
    g = h * (0.5 + 0.5 * torch.tanh(c * h))
    return torch.clamp(torch.round(g), -127, 127).to(torch.int8)


def int8_gemm_bf16_plain(a, w, scale, bias, row_scale=None):
    return dequant_plain(int8_matmul_plain(a, w), scale, bias, row_scale).to(torch.bfloat16)


def int8_gemm_residual_plain(a, w, scale, bias, resid, row_scale=None):
    y = dequant_plain(int8_matmul_plain(a, w), scale, bias, row_scale)
    return (resid.float() + y).to(resid.dtype)


def int8_gemm_f32_plain(a, w, scale, bias, row_scale=None):
    return dequant_plain(int8_matmul_plain(a, w), scale, bias, row_scale)


def int8_gemm_gelu_quant_plain(a, w, scale, bias, gelu_c):
    return gelu_quant_plain(dequant_plain(int8_matmul_plain(a, w), scale, bias), gelu_c)


def int8_gemm_rowscale_plain(a, w, row_scale, scale, bias, out_dtype=torch.bfloat16):
    return rowscale_plain(int8_matmul_plain(a, w), row_scale, scale, bias).to(out_dtype)


def _launch(epilogue, a, w, out_dtype, *, scale=None, bias=None, resid=None, gelu_c=None,
            row_scale=None):
    m, k = a.shape
    n = w.shape[0]
    if a.dtype != torch.int8 or w.dtype != torch.int8 or w.shape[1] != k:
        raise ValueError(f"int8 GEMM takes int8 a [M, K] and w [N, K], got {a.shape}, {w.shape}")
    if m < 1 or k < 16 or k % 16 or n < 8 or n % 8:
        raise ValueError(f"int8 GEMM needs M >= 1, K a positive multiple of 16 and N of 8, "
                         f"got M={m}, K={k}, N={n}")
    bn, blocks = gemm_plan(epilogue, m, n, k, wgmma_gemm.sm_count(a.device.index))
    wgmma_gemm.check_shape(m, n, k, "int8 GEMM", bn)
    args = [a, w]
    for name, t, dt, shape in (("scale", scale, torch.float32, (n,)),
                               ("bias", bias, torch.float32, (n,)),
                               ("resid", resid, out_dtype, (m, n)),
                               ("gelu_c", gelu_c, torch.float32, None),
                               ("row_scale", row_scale, torch.float32, (m,))):
        if t is None:
            continue
        if t.dtype != dt or t.device != a.device or (shape and tuple(t.shape) != shape):
            raise ValueError(f"{name} must be {dt} {shape} on {a.device}")
        args.append(t)
    if any(not t.is_contiguous() for t in args) or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8 GEMM operands must be contiguous, a and w 16-byte aligned "
                         "(TMA's rule)")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.load()
    err = lib.jcf_int8_gemm(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, _EPILOGUES[epilogue],
        *(t.data_ptr() if t is not None else None for t in (scale, bias, resid, gelu_c, row_scale)),
        bn, blocks, _build.stream_ptr(a.device),
    )
    _build.check(err, f"int8_gemm_{epilogue}")
    LAUNCHES[f"int8_gemm_{epilogue}"] += 1
    return out


def int8_gemm_s32(a, w):
    if not a.is_cuda:
        return int8_matmul_plain(a, w)
    return _launch("s32", a, w, torch.int32)


def _rows(epilogue, row_scale):
    return epilogue if row_scale is None else f"{epilogue}_rows"


def int8_gemm_bf16(a, w, scale, bias, row_scale=None):
    if not a.is_cuda:
        return int8_gemm_bf16_plain(a, w, scale, bias, row_scale)
    return _launch(_rows("bf16", row_scale), a, w, torch.bfloat16, scale=scale, bias=bias,
                   row_scale=row_scale)


def int8_gemm_residual(a, w, scale, bias, resid, row_scale=None):
    """The residual epilogue, bf16 or f32 as ``resid`` is."""
    if not a.is_cuda:
        return int8_gemm_residual_plain(a, w, scale, bias, resid, row_scale)
    if resid.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the residual epilogue takes a bf16 or f32 residual, not {resid.dtype}")
    epi = "residual" if resid.dtype == torch.bfloat16 else "residual_f32"
    return _launch(_rows(epi, row_scale), a, w, resid.dtype, scale=scale, bias=bias, resid=resid,
                   row_scale=row_scale)


def int8_gemm_f32(a, w, scale, bias, row_scale=None):
    if not a.is_cuda:
        return int8_gemm_f32_plain(a, w, scale, bias, row_scale)
    return _launch(_rows("f32", row_scale), a, w, torch.float32, scale=scale, bias=bias,
                   row_scale=row_scale)


def int8_gemm_gelu_quant(a, w, scale, bias, gelu_c):
    if not a.is_cuda:
        return int8_gemm_gelu_quant_plain(a, w, scale, bias, gelu_c)
    return _launch("gelu_quant", a, w, torch.int8, scale=scale, bias=bias, gelu_c=gelu_c)


def int8_gemm_rowscale(a, w, row_scale, scale, bias, out_dtype=torch.bfloat16):
    """[M, K] int8 rows with their f32 scales [M] times w [N, K] with its
    [N] scales and bias -> [M, N] in ``out_dtype``. The kernel gives bf16
    only; the plain version rounds its f32 result to ``out_dtype``."""
    if not a.is_cuda:
        return int8_gemm_rowscale_plain(a, w, row_scale, scale, bias, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the row-scale epilogue writes bf16, not {out_dtype}")
    return _launch("rowscale", a, w, torch.bfloat16, scale=scale, bias=bias, row_scale=row_scale)
