"""bf16 x bf16 -> f32 GEMM with fused epilogues (``csrc/bf16_gemm.cu``).

``a [M, K]`` bf16 activations times ``w [N, K]`` bf16 weights (the JAX
``[out, in]`` layout, cast from f32 as ``.astype(x.dtype)``), accumulated
in f32, with an f32 bias, then one of:

- ``bf16_gemm_bias``: ``bf16(acc + bias)`` (qkv projection);
- ``bf16_gemm_residual``: ``bf16(resid + (acc + bias))`` with the residual
  add in f32 (out-proj, c_proj);
- ``bf16_gemm_gelu``: ``bf16(h * (0.5 + 0.5 tanh(0.851 h)))``,
  ``h = acc + bias`` (c_fc with QuickGELU in f32, ``_quick_gelu32``).

These are the products inside ``jcf_tpu``'s ``_attn_half_kernel`` and
``_mlp_half_kernel`` (K6a, K6b). Each wrapper launches the CUDA kernel for
CUDA tensors and runs its plain version for CPU tensors.

The kernel (wgmma fed by TMA, as the int8 GEMM) computes 128 x 128
output tiles, block b of a grid of B taking tiles b, b + B, ...
(N-fastest); ``gemm_plan`` picks B.
"""

from __future__ import annotations

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops import wgmma_gemm
from jcf_tpu_torch.ops.layers import GELU_TANH_COEF

_EPILOGUES = {"bias": 0, "residual": 1, "gelu": 2}
# launches of the GEMM kernel, by epilogue
LAUNCHES = {f"bf16_gemm_{e}": 0 for e in _EPILOGUES}

def gemm_plan(m: int, n: int, k: int, sms: int) -> int:
    """The grid over the 128 x 128 output tiles (``wgmma_gemm.grid``): two
    blocks an SM, persistent from K 2048 on."""
    return wgmma_gemm.grid(m, n, wgmma_gemm.BN, sms, 2, k >= wgmma_gemm.PERSISTENT_K)


def matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``a @ w.T`` of bf16 operands (every product exact in f32)."""
    return torch.matmul(a.float(), w.float().T)


def gelu_plain(h: torch.Tensor) -> torch.Tensor:
    """QuickGELU in its tanh form, in f32."""
    return h * (0.5 + 0.5 * torch.tanh(GELU_TANH_COEF * h))


def _launch(epilogue, a, w, bias, resid=None):
    m, k = a.shape
    n = w.shape[0]
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or w.shape[1] != k:
        raise ValueError(f"bf16 GEMM takes bf16 a [M, K] and w [N, K], got {a.dtype} {tuple(a.shape)}, "
                         f"{w.dtype} {tuple(w.shape)}")
    if m < 1 or k < 8 or k % 8 or n < 8 or n % 8:
        raise ValueError(f"bf16 GEMM needs M >= 1 and K, N positive multiples of 8 (TMA's "
                         f"16-byte rows, the epilogue's column pairs), got M={m}, K={k}, N={n}")
    wgmma_gemm.check_shape(m, n, 2 * k, "bf16 GEMM")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (n,) or bias.device != a.device:
        raise ValueError(f"bias must be f32 ({n},) on {a.device}")
    if resid is not None and (resid.dtype != torch.bfloat16 or tuple(resid.shape) != (m, n)
                              or resid.device != a.device):
        raise ValueError(f"resid must be bf16 ({m}, {n}) on {a.device}")
    args = [t for t in (a, w, bias, resid) if t is not None]
    if any(not t.is_contiguous() for t in args) or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("bf16 GEMM operands must be contiguous, a and w 16-byte aligned "
                         "(TMA's rule)")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    blocks = gemm_plan(m, n, k, wgmma_gemm.sm_count(a.device.index))
    lib = _build.load()
    err = lib.jcf_bf16_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                            _EPILOGUES[epilogue], bias.data_ptr(),
                            resid.data_ptr() if resid is not None else None, blocks,
                            _build.stream_ptr(a.device))
    _build.check(err, f"bf16_gemm_{epilogue}")
    LAUNCHES[f"bf16_gemm_{epilogue}"] += 1
    return out


def bf16_gemm_bias_plain(a, w, bias):
    return (matmul_plain(a, w) + bias).to(torch.bfloat16)


def bf16_gemm_residual_plain(a, w, bias, resid):
    return (resid.float() + (matmul_plain(a, w) + bias)).to(torch.bfloat16)


def bf16_gemm_gelu_plain(a, w, bias):
    return gelu_plain(matmul_plain(a, w) + bias).to(torch.bfloat16)


def bf16_gemm_bias(a, w, bias):
    if not a.is_cuda:
        return bf16_gemm_bias_plain(a, w, bias)
    return _launch("bias", a, w, bias)


def bf16_gemm_residual(a, w, bias, resid):
    if not a.is_cuda:
        return bf16_gemm_residual_plain(a, w, bias, resid)
    return _launch("residual", a, w, bias, resid)


def bf16_gemm_gelu(a, w, bias):
    if not a.is_cuda:
        return bf16_gemm_gelu_plain(a, w, bias)
    return _launch("gelu", a, w, bias)
