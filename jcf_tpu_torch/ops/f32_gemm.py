"""f32 x f32 -> f32 GEMM with fused epilogues (``csrc/f32_gemm.cu``).

``a [M, K]`` f32 activations times ``w [N, K]`` f32 weights (the JAX
``[out, in]`` layout), every product an f32 FMA on the CUDA cores (no
TF32), with an f32 bias, then one of:

- ``f32_gemm_bias``: ``acc + bias`` (qkv projection);
- ``f32_gemm_residual``: ``resid + (acc + bias)`` (out-proj, c_proj);
- ``f32_gemm_gelu``: ``h * (0.5 + 0.5 tanh(0.851 h))``, ``h = acc + bias``
  (c_fc with QuickGELU, ``_quick_gelu32``).

These are the products inside ``jcf_tpu``'s ``_attn_half_kernel`` and
``_mlp_half_kernel`` (K6a, K6b) on the f32 towers, which the TPU runs at
``Precision.HIGHEST``. Each wrapper launches the CUDA kernel for CUDA
tensors and runs its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops.bf16_gemm import gelu_plain

_EPILOGUES = {"bias": 0, "residual": 1, "gelu": 2}
# launches of the GEMM kernel, by epilogue
LAUNCHES = {f"f32_gemm_{e}": 0 for e in _EPILOGUES}


def f32_gemm_bias_plain(a, w, bias):
    return torch.matmul(a, w.T) + bias


def f32_gemm_residual_plain(a, w, bias, resid):
    return resid + (torch.matmul(a, w.T) + bias)


def f32_gemm_gelu_plain(a, w, bias):
    return gelu_plain(torch.matmul(a, w.T) + bias)


def _launch(epilogue, a, w, bias, resid=None):
    m, k = a.shape
    n = w.shape[0]
    f32 = torch.float32
    if a.dtype != f32 or w.dtype != f32 or w.shape[1] != k:
        raise ValueError(f"f32 GEMM takes f32 a [M, K] and w [N, K], got {a.dtype} "
                         f"{tuple(a.shape)}, {w.dtype} {tuple(w.shape)}")
    if k % 4 or n % 4 or m > 65535 * 128:
        raise ValueError(f"f32 GEMM needs K % 4 == 0, N % 4 == 0 and M <= 65535 * 128 "
                         f"(the grid's row limit), got M={m}, K={k}, N={n}")
    if bias.dtype != f32 or tuple(bias.shape) != (n,) or bias.device != a.device:
        raise ValueError(f"bias must be f32 ({n},) on {a.device}")
    if resid is not None and (resid.dtype != f32 or tuple(resid.shape) != (m, n)
                              or resid.device != a.device):
        raise ValueError(f"resid must be f32 ({m}, {n}) on {a.device}")
    args = [t for t in (a, w, bias, resid) if t is not None]
    if any(not t.is_contiguous() for t in args) or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("f32 GEMM operands must be contiguous, a and w 16-byte aligned")
    out = torch.empty((m, n), dtype=f32, device=a.device)
    lib = _build.load()
    err = lib.jcf_f32_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                           _EPILOGUES[epilogue], bias.data_ptr(),
                           resid.data_ptr() if resid is not None else None,
                           _build.stream_ptr(a.device))
    _build.check(err, f"f32_gemm_{epilogue}")
    LAUNCHES[f"f32_gemm_{epilogue}"] += 1
    return out


def f32_gemm_bias(a, w, bias):
    if not a.is_cuda:
        return f32_gemm_bias_plain(a, w, bias)
    return _launch("bias", a, w, bias)


def f32_gemm_residual(a, w, bias, resid):
    if not a.is_cuda:
        return f32_gemm_residual_plain(a, w, bias, resid)
    return _launch("residual", a, w, bias, resid)


def f32_gemm_gelu(a, w, bias):
    if not a.is_cuda:
        return f32_gemm_gelu_plain(a, w, bias)
    return _launch("gelu", a, w, bias)
