"""The f32 products of the port's wgmma kernels, emulated on the CPU: each
product as three TF32 products (``csrc/f32_gemm.cu``, and K9b in f32,
``csrc/block_float.cu``), for the tests that hold that arithmetic against
JAX at ``Precision.HIGHEST``."""

import torch

from jcf_tpu_torch.ops import f32_gemm as tfg


def _add_rz(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32 ``x + y`` rounded toward zero, as the tensor cores add into an
    accumulator: the sum in float64 (exact for the 8 products of a k8 step
    and an f32 partial of these sizes), rounded to f32, then stepped one
    ulp back toward zero where that rounding went away from it."""
    exact = x.double() + y
    r = exact.float()
    return torch.where(r.double().abs() > exact.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def split_products(a: torch.Tensor, w: torch.Tensor, depth: int | None = 32) -> torch.Tensor:
    """``a @ w.T`` as the kernel takes it: K zero-padded to a multiple of
    32 (a stage); per k8 step a_lo b_hi, then a_hi b_lo, then a_hi b_hi,
    each a sum of 8 products exact in f32, added to the partial sum with
    the tensor cores' truncating add (``_add_rz``); each ``depth``-deep
    partial sum (a stage) added to the tile's sum in f32, rounded to
    nearest. ``depth=None``: one accumulator over all of K, the design
    the kernel does not take."""
    k = a.shape[1]
    kp = k + -k % 32
    sa = torch.nn.functional.pad(tfg.tf32_split_plain(a), (0, kp - k)).double()
    sw = torch.nn.functional.pad(tfg.tf32_split_plain(w), (0, kp - k)).double()
    depth = depth or kp
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float32)
    for s0 in range(0, kp, depth):
        part = torch.zeros_like(acc)
        for s in range(s0, s0 + depth, 8):
            for x, y in ((sa[1], sw[0]), (sa[0], sw[1]), (sa[0], sw[0])):
                part = _add_rz(part, torch.matmul(x[:, s:s + 8], y[:, s:s + 8].T))
        acc = acc + part
    return acc
