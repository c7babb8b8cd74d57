"""Probe P3 on an H100: attention per head on the tensor cores against
the CUDA-core loop.

Port of ``scripts/exp_batched_dot.py``: softmax attention over heads of
[56, 64] bf16 q, k, v at tower scale (``GRID`` 128 steps of ``GROUP`` 8
crops x ``H`` 12 heads: 12,288 heads), no 1/sqrt(d), p normalized in f32
and rounded to bf16 before PV. Two kernels (``csrc/batched_dot.cu``):
``batched_dot_mma``, the counterpart of the TPU probe's ``kernel_batched``
(all heads in one batched product), on the tensor cores; and
``batched_dot_loop``, the counterpart of ``kernel_loop`` (the heads in
sequence), the CUDA-core row loop of ``csrc/pair_attention.cuh`` that
K3's, K6a's and K9's attention use. Each is held to the plain version,
timed with CUDA events, and printed beside its bound (the bytes of q, k,
v and o over ``PEAK_BYTES``: the products at ``PEAK_BF16`` take a tenth
of that) and beside ``F.scaled_dot_product_attention(q, k, v,
scale=1.0)``, a yardstick that the port never calls.

    python -m jcf_tpu_torch.scripts.exp_batched_dot            # the card
    python -m jcf_tpu_torch.scripts.exp_batched_dot --device cpu --grid 1 --group 1
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from jcf_tpu_torch import _build
from jcf_tpu_torch.scripts.common import PEAK_BF16, bound_ms, card_line, time_ms

# the TPU probe's shapes (scripts/exp_batched_dot.py:31-32)
GROUP, S, H, D = 8, 56, 12, 64
GRID = 128  # b // group at 1024 crops

# launches of each kernel (CUDA tensors only)
LAUNCHES = {"batched_dot_mma": 0, "batched_dot_loop": 0}


def probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) per head in f32, normalized by an f32 division."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def batched_dot_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The probe's function in plain PyTorch: q, k, v [B, S, D] bf16 ->
    [B, S, D] bf16. Scores, max, exp and the division by the sum in f32;
    p rounded to bf16 for PV with f32 sums."""
    return torch.matmul(probs(q, k).to(v.dtype).float(), v.float()).to(q.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The library yardstick: one ``scaled_dot_product_attention`` call
    with scale 1 on the heads as [1, B, S, D] (normalization deferred past
    PV, so not bit for bit the same function). Given [B, S, D] itself, the
    call takes its slower math route on the card."""
    return F.scaled_dot_product_attention(q[None], k[None], v[None], scale=1.0)[0]


def _launch(name: str, q, k, v) -> torch.Tensor:
    if not (q.shape == k.shape == v.shape) or q.dim() != 3 or q.shape[-1] != D or \
            not 0 < q.shape[1] <= 64:
        raise ValueError(f"{name} takes q, k, v [B, S <= 64, {D}] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    ts = (q, k, v)
    if any(t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous()
           or t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned bf16 on one device")
    out = torch.empty_like(q)
    err = getattr(_build.load(), f"jcf_{name}")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                out.data_ptr(), q.shape[0], q.shape[1],
                                                _build.stream_ptr(q.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def batched_dot_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, S <= 64, 64] bf16 -> [B, S, 64] bf16: the tensor-core
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return batched_dot_plain(q, k, v)
    return _launch("batched_dot_mma", q, k, v)


def batched_dot_loop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """As ``batched_dot_mma``, with the CUDA-core row loop on the card."""
    if not q.is_cuda:
        return batched_dot_plain(q, k, v)
    return _launch("batched_dot_loop", q, k, v)


KERNELS = {"batched": batched_dot_mma, "loop": batched_dot_loop}


def work(b: int, s: int, d: int):
    """(bytes, bf16 flops) of one call: q, k, v read and o written once;
    the multiply-adds of QK^T and PV x 2."""
    return 4 * b * s * d * 2, 2 * 2 * b * s * s * d


def inputs(b: int, device, seed: int = 0, s: int = S):
    """Seeded standard-normal q, k, v [b, s, D] in bf16 on ``device``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, D), np.float32)).to(device, torch.bfloat16)
            for _ in range(3)]


def run(grid: int = GRID, group: int = GROUP, device="cuda", iters: int = 20,
        seed: int = 0) -> dict:
    """Times both kernels and the library call, holds each kernel to the
    plain version (bf16 within 1 ulp + 1e-3 + 2^-7 sum_j p_j |v_j|, the
    rounding of p) and prints one line each; returns the numbers."""
    device = torch.device(device)
    smi = card_line(device)
    print(smi, flush=True)
    b = grid * group * H
    q, k, v = inputs(b, device, seed)
    ref = batched_dot_plain(q, k, v)
    slack = 2.0**-7 * torch.matmul(probs(q, k), v.float().abs())
    n_bytes, flops = work(b, S, D)
    bound, by = bound_ms(n_bytes, flops, PEAK_BF16)
    unit = "ms on the card" if device.type == "cuda" else "ms, host clock (CPU)"
    res = {"heads": b, "bound_ms": bound, "bound_by": by}
    for name, fn in KERNELS.items():
        out = fn(q, k, v)
        err = check_close(out, ref, slack)
        ms = time_ms(lambda: fn(q, k, v), device, iters)
        res[name] = {"ms": ms, "max_abs_err": err}
        print(f"{name:8s}: {ms:8.4f} {unit} ({n_bytes / (ms * 1e-3) / 1e9:.0f} GB/s), H100 bound "
              f"{bound:.4f} ms ({by}), out[0,0,0]={float(out[0, 0, 0]):.4f}, max |diff| vs plain "
              f"{err:.3e}; {smi}", flush=True)
    lib = time_ms(lambda: sdpa(q, k, v), device, iters)
    res["library_ms"] = lib
    print(f"sdpa    : {lib:8.4f} {unit} (F.scaled_dot_product_attention, scale 1; a yardstick); "
          f"{smi}", flush=True)
    return res


def check_close(got, ref, slack) -> float:
    """Max |got - ref|; raises where it exceeds 1 bf16 ulp + 1e-3 +
    ``slack``."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    tol = 2.0**-7 * g.abs().maximum(r.abs()) + 1e-3 + slack
    if bool((d > tol).any()) or not bool(g.isfinite().all()):
        raise AssertionError(f"batched dot differs from the plain version: {int((d > tol).sum())} "
                             f"elements over the bar, max |diff| {float(d.max()):.3e}")
    return float(d.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--group", type=int, default=GROUP, help="crops a grid step (x 12 heads)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.grid, args.group, args.device, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
