"""int8 x int8 -> int32 GEMM with fused epilogues (``csrc/int8_gemm.cu``).

``a [M, K]`` int8 activations times ``w [N, K]`` int8 weights (the JAX
``[out, in]`` layout), accumulated exactly in int32, then one of:

- ``int8_gemm_s32``: the raw int32 accumulators (patch embed);
- ``int8_gemm_bf16``: ``bf16(acc * scale + bias)`` (qkv projection);
- ``int8_gemm_residual``: ``bf16(resid + (acc * scale + bias))`` with the
  residual add in f32 (out-proj, c_proj);
- ``int8_gemm_gelu_quant``: ``int8(round(h * (0.5 + 0.5 tanh(c h))))``,
  ``h = acc * scale + bias`` (c_fc with the static hidden scale folded,
  ``jcf_tpu`` ``_gelu_quant_static``).

Each wrapper launches the CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors. The plain product runs in float64, which holds
every partial sum of int8 products exactly (|acc| < 2**53).
"""

from __future__ import annotations

import torch

from jcf_tpu_torch import _build

_EPILOGUES = {"s32": 0, "bf16": 1, "residual": 2, "gelu_quant": 3}
# launches of the GEMM kernel, by epilogue
LAUNCHES = {f"int8_gemm_{e}": 0 for e in _EPILOGUES}


def int8_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ w.T`` for int8 a [M, K], w [N, K]."""
    return torch.matmul(a.double(), w.double().T).to(torch.int32)


def dequant_plain(acc, scale, bias):
    return acc.float() * scale + bias


def gelu_quant_plain(h, c):
    """QuickGELU in tanh form on values already in the quantized domain,
    then round-half-even and saturate to int8."""
    g = h * (0.5 + 0.5 * torch.tanh(c * h))
    return torch.clamp(torch.round(g), -127, 127).to(torch.int8)


def _launch(epilogue, a, w, out_dtype, *, scale=None, bias=None, resid=None, gelu_c=None):
    m, k = a.shape
    n = w.shape[0]
    if a.dtype != torch.int8 or w.dtype != torch.int8 or w.shape[1] != k:
        raise ValueError(f"int8 GEMM takes int8 a [M, K] and w [N, K], got {a.shape}, {w.shape}")
    if k % 16 or n % 8 or m > 65535 * 128:
        raise ValueError(f"int8 GEMM needs K % 16 == 0, N % 8 == 0 and M <= 65535 * 128 "
                         f"(the grid's row limit), got M={m}, K={k}, N={n}")
    args = [a, w]
    for name, t, dt, shape in (("scale", scale, torch.float32, (n,)),
                               ("bias", bias, torch.float32, (n,)),
                               ("resid", resid, torch.bfloat16, (m, n)),
                               ("gelu_c", gelu_c, torch.float32, None)):
        if t is None:
            continue
        if t.dtype != dt or t.device != a.device or (shape and tuple(t.shape) != shape):
            raise ValueError(f"{name} must be {dt} {shape} on {a.device}")
        args.append(t)
    if any(not t.is_contiguous() for t in args) or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8 GEMM operands must be contiguous, a and w 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.load()
    err = lib.jcf_int8_gemm(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, _EPILOGUES[epilogue],
        *(t.data_ptr() if t is not None else None for t in (scale, bias, resid, gelu_c)),
        _build.stream_ptr(a.device),
    )
    _build.check(err, f"int8_gemm_{epilogue}")
    LAUNCHES[f"int8_gemm_{epilogue}"] += 1
    return out


def int8_gemm_s32(a, w):
    if not a.is_cuda:
        return int8_matmul_plain(a, w)
    return _launch("s32", a, w, torch.int32)


def int8_gemm_bf16(a, w, scale, bias):
    if not a.is_cuda:
        return dequant_plain(int8_matmul_plain(a, w), scale, bias).to(torch.bfloat16)
    return _launch("bf16", a, w, torch.bfloat16, scale=scale, bias=bias)


def int8_gemm_residual(a, w, scale, bias, resid):
    if not a.is_cuda:
        y = dequant_plain(int8_matmul_plain(a, w), scale, bias)
        return (resid.float() + y).to(torch.bfloat16)
    return _launch("residual", a, w, torch.bfloat16, scale=scale, bias=bias, resid=resid)


def int8_gemm_gelu_quant(a, w, scale, bias, gelu_c):
    if not a.is_cuda:
        return gelu_quant_plain(dequant_plain(int8_matmul_plain(a, w), scale, bias), gelu_c)
    return _launch("gelu_quant", a, w, torch.int8, scale=scale, bias=bias, gelu_c=gelu_c)
