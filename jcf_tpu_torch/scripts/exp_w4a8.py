"""Probe P1 on an H100: one MLP half with int8 weights, and with int4
weights unpacked in the GEMM's load path or once before it.

Port of ``scripts/exp_w4a8.py``: one layer's MLP half at serving shapes
(``ROWS`` 409,600 bf16 rows of width ``E`` 768, hidden ``HID`` 3072), the
TPU probe's ``_mlp_math``: LN without its affine, static row quant with
inv 28, int8 c_fc x 3e-4, QuickGELU (tanh form) and the static hidden
quant with h_inv 10, int8 c_proj x 3e-4, the residual add in f32, bf16
out. Three variants, as the TPU probe's kernels:

- ``int8`` (``k_int8``): the port's K4 kernels, ``block_kernel.ln_quant``
  then ``int8_gemm_gelu_quant`` (c_fc: w_scale filled with 3e-4, zero
  bias, c = 0.851 / 10) and ``int8_gemm_residual`` (c_proj);
- ``w4_step`` (``k_w4_step``): the same with both GEMMs reading the
  packed int4 weights (``w4a8_gemm``, ``csrc/w4a8.cu``: each 16-byte
  load carries 32 nibbles, sign-extended to int8 in registers);
- ``w4_cache`` (``k_w4_cache``): ``unpack_int4`` once a call into int8
  [N, K] buffers, then the ``int8`` variant on them.

The weights are drawn in [-7, 7], so the int8 and int4 forms hold the same
values: the three outputs are equal bit for bit (the run checks it, and
prints the TPU probe's checksum, sum |out|). Each variant's time is
printed beside the bound of its products (2 x ROWS x E x HID x 2 int8
operations over ``PEAK_INT8``) and beside ``torch._int_mm`` for the two
products alone, a yardstick of another function that the port never calls.

    python -m jcf_tpu_torch.scripts.exp_w4a8              # the card
    python -m jcf_tpu_torch.scripts.exp_w4a8 --device cpu --rows 64
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np
import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops import block_kernel as bk
from jcf_tpu_torch.ops import int8_gemm as ig
from jcf_tpu_torch.scripts.common import PEAK_INT8, bound_ms, card_line, time_ms

# the TPU probe's shapes and constants (scripts/exp_w4a8.py:46-50, 67-80)
E, HID, S = 768, 3072, 50
ROWS = 8192 * S
W_SCALE, LN_INV, H_INV = 3e-4, 28.0, 10.0

# launches of each kernel (CUDA tensors only)
LAUNCHES = {"w4a8_gemm_gelu_quant": 0, "w4a8_gemm_residual": 0, "unpack_int4": 0}
_EPILOGUES = {"gelu_quant": 0, "residual": 1}


def pack(w: np.ndarray) -> torch.Tensor:
    """int8 [r, c] with values in [-8, 7] -> packed int8 [r, c/2]: byte j
    holds column j in its low nibble and column j + c/2 in its high one
    (the TPU probe's ``pack``)."""
    wi = np.asarray(w).astype(np.int8)
    half = wi.shape[1] // 2
    lo = wi[:, :half] & 0xF
    hi = (wi[:, half:] & 0xF) << 4
    return torch.from_numpy((lo | hi).astype(np.uint8).view(np.int8))


def unpack_int4_plain(packed: torch.Tensor) -> torch.Tensor:
    """packed int8 [r, c/2] -> int8 [r, c]: each nibble sign-extended by
    shifts on int32 (the TPU probe's ``_unpack_int4``)."""
    wi = packed.to(torch.int32)
    lo = (wi << 28) >> 28
    hi = (wi << 24) >> 28
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """As ``unpack_int4_plain``: the kernel for a CUDA tensor (the row
    length a multiple of 16 bytes), the plain version for a CPU tensor."""
    if not packed.is_cuda:
        return unpack_int4_plain(packed)
    if packed.dim() != 2 or packed.dtype != torch.int8 or packed.shape[1] % 16 or \
            not packed.is_contiguous() or packed.data_ptr() % 16:
        raise ValueError(f"unpack_int4 takes contiguous, aligned int8 [N, K/2] with K/2 % 16 == "
                         f"0, got {packed.dtype} {tuple(packed.shape)}")
    n, half = packed.shape
    out = torch.empty((n, 2 * half), dtype=torch.int8, device=packed.device)
    err = _build.load().jcf_unpack_int4(packed.data_ptr(), out.data_ptr(), n, 2 * half,
                                        _build.stream_ptr(packed.device))
    _build.check(err, "unpack_int4")
    LAUNCHES["unpack_int4"] += 1
    return out


def _w4_launch(epilogue, a, w4, out_dtype, scale, bias, *, resid=None, gelu_c=None):
    name = f"w4a8_gemm_{epilogue}"
    m, k = a.shape
    n = w4.shape[0]
    if a.dtype != torch.int8 or w4.dtype != torch.int8 or w4.dim() != 2 or 2 * w4.shape[1] != k:
        raise ValueError(f"{name} takes int8 a [M, K] and packed int8 w [N, K/2], got "
                         f"{tuple(a.shape)}, {tuple(w4.shape)}")
    if k % 64 or n % 8 or m > 65535 * 128:
        raise ValueError(f"{name} needs K % 64 == 0, N % 8 == 0 and M <= 65535 * 128, got M={m}, "
                         f"K={k}, N={n}")
    for label, t, dt, shape in (("scale", scale, torch.float32, (n,)),
                                ("bias", bias, torch.float32, (n,)),
                                ("resid", resid, torch.bfloat16, (m, n)),
                                ("gelu_c", gelu_c, torch.float32, None)):
        if t is not None and (t.dtype != dt or t.device != a.device or
                              (shape and tuple(t.shape) != shape) or (not shape and t.numel() != 1)):
            raise ValueError(f"{name}: {label} must be {dt} {shape or 'one element'} on {a.device}")
    ts = [t for t in (a, w4, scale, bias, resid, gelu_c) if t is not None]
    if any(not t.is_contiguous() for t in ts) or a.data_ptr() % 16 or w4.data_ptr() % 16:
        raise ValueError(f"{name} operands must be contiguous, a and w 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.load().jcf_w4a8_gemm(
        a.data_ptr(), w4.data_ptr(), out.data_ptr(), m, n, k, _EPILOGUES[epilogue],
        scale.data_ptr(), bias.data_ptr(), *(t.data_ptr() if t is not None else None
                                             for t in (resid, gelu_c)),
        _build.stream_ptr(a.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def w4a8_gemm_gelu_quant_plain(a, w4, scale, bias, gelu_c):
    """The plain int8 GELU-quant GEMM on the unpacked weight."""
    return ig.int8_gemm_gelu_quant_plain(a, unpack_int4_plain(w4), scale, bias, gelu_c)


def w4a8_gemm_residual_plain(a, w4, scale, bias, resid):
    """The plain int8 residual GEMM on the unpacked weight."""
    return ig.int8_gemm_residual_plain(a, unpack_int4_plain(w4), scale, bias, resid)


def w4a8_gemm_gelu_quant(a, w4, scale, bias, gelu_c):
    """``ig.int8_gemm_gelu_quant`` with the weight given packed [N, K/2]:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not a.is_cuda:
        return w4a8_gemm_gelu_quant_plain(a, w4, scale, bias, gelu_c)
    return _w4_launch("gelu_quant", a, w4, torch.int8, scale, bias, gelu_c=gelu_c)


def w4a8_gemm_residual(a, w4, scale, bias, resid):
    """``ig.int8_gemm_residual`` (bf16 residual) with the weight packed."""
    if not a.is_cuda:
        return w4a8_gemm_residual_plain(a, w4, scale, bias, resid)
    return _w4_launch("residual", a, w4, torch.bfloat16, scale, bias, resid=resid)


def constants(device) -> dict:
    """The probe's scales as the K4 kernels take them: the static LN inv,
    w_scale 3e-4 and zero bias for both GEMMs, and GELU's c = 0.851 / h_inv
    in f32 (``_gelu_quant_static``)."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"ln_inv": torch.full((1,), LN_INV, **f32),
            "fc_scale": torch.full((HID,), W_SCALE, **f32), "fc_bias": torch.zeros(HID, **f32),
            "proj_scale": torch.full((E,), W_SCALE, **f32), "proj_bias": torch.zeros(E, **f32),
            "gelu_c": torch.tensor(bk.GELU_TANH_COEF, **f32) / torch.tensor(H_INV, **f32)}


def mlp_int8(x, wfc, wproj, c):
    """``k_int8`` through the K4 kernels: x [M, E] bf16, wfc [HID, E] and
    wproj [E, HID] int8 -> [M, E] bf16."""
    x_q = bk.ln_quant(x, c["ln_inv"])
    h_q = ig.int8_gemm_gelu_quant(x_q, wfc, c["fc_scale"], c["fc_bias"], c["gelu_c"])
    return ig.int8_gemm_residual(h_q, wproj, c["proj_scale"], c["proj_bias"], x)


def mlp_w4_step(x, wfc4, wproj4, c):
    """``k_w4_step``: both GEMMs read the packed weights."""
    x_q = bk.ln_quant(x, c["ln_inv"])
    h_q = w4a8_gemm_gelu_quant(x_q, wfc4, c["fc_scale"], c["fc_bias"], c["gelu_c"])
    return w4a8_gemm_residual(h_q, wproj4, c["proj_scale"], c["proj_bias"], x)


def mlp_w4_cache(x, wfc4, wproj4, c):
    """``k_w4_cache``: the weights unpacked once a call, then ``mlp_int8``."""
    return mlp_int8(x, unpack_int4(wfc4), unpack_int4(wproj4), c)


def mlp_w4a8_plain(x, wfc, wproj, c):
    """The probe's ``_mlp_math`` in plain PyTorch: the plain versions of
    the K4 kernels that ``mlp_int8`` runs."""
    x_q = bk.ln_quant_plain(x, c["ln_inv"])
    h_q = ig.int8_gemm_gelu_quant_plain(x_q, wfc, c["fc_scale"], c["fc_bias"], c["gelu_c"])
    return ig.int8_gemm_residual_plain(h_q, wproj, c["proj_scale"], c["proj_bias"], x)


def weights(seed: int = 0):
    """(wfc [HID, E], wproj [E, HID]) int8 in [-7, 7], as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-7, 8, (HID, E)).astype(np.int8),
            rng.integers(-7, 8, (E, HID)).astype(np.int8))


def work(rows: int):
    """(bytes, int8 ops) of one MLP half: x read and out written once in
    bf16, the int8 weights read once; 2 x rows x E x HID multiply-adds x 2."""
    return 2 * rows * E * 2 + 2 * E * HID, 2 * 2 * rows * E * HID


def run(rows: int = ROWS, device="cuda", iters: int = 9, seed: int = 0) -> dict:
    """Times the three variants on three distinct inputs in turn (the TPU
    probe's fresh-input rule), checks their outputs equal, prints one line
    each; returns the numbers."""
    device = torch.device(device)
    smi = card_line(device)
    print(smi, flush=True)
    wfc_np, wproj_np = weights(seed)
    wfc, wproj = torch.from_numpy(wfc_np).to(device), torch.from_numpy(wproj_np).to(device)
    wfc4, wproj4 = pack(wfc_np).to(device), pack(wproj_np).to(device)
    c = constants(device)
    rng = np.random.default_rng(seed + 1)
    xs = [torch.from_numpy(rng.standard_normal((rows, E), np.float32)).to(device, torch.bfloat16)
          for _ in range(3)]
    variants = {"int8": lambda x: mlp_int8(x, wfc, wproj, c),
                "w4_step": lambda x: mlp_w4_step(x, wfc4, wproj4, c),
                "w4_cache": lambda x: mlp_w4_cache(x, wfc4, wproj4, c)}
    n_bytes, ops = work(rows)
    bound, by = bound_ms(n_bytes, ops, PEAK_INT8)
    unit = "ms on the card" if device.type == "cuda" else "ms, host clock (CPU)"
    res = {"rows": rows, "bound_ms": bound, "bound_by": by}
    outs = {}
    for kind, fn in variants.items():
        turns = itertools.cycle(xs)
        ms = time_ms(lambda: fn(next(turns)), device, iters)
        outs[kind] = fn(xs[0])
        checksum = float(outs[kind].float().abs().sum())
        res[kind] = {"ms": ms, "checksum": checksum}
        print(f"{kind:9s} {ms:9.4f} {unit}  (checksum {checksum:.6e}); H100 bound {bound:.4f} ms "
              f"({by}); {smi}", flush=True)
    for kind in ("w4_step", "w4_cache"):
        if not torch.equal(outs[kind], outs["int8"]):
            raise AssertionError(f"{kind} differs from int8: the weights hold the same values")
    print("int8, w4_step and w4_cache outputs equal bit for bit", flush=True)
    del outs
    if device.type == "cuda":
        x_q = bk.ln_quant(xs[0], c["ln_inv"])
        h_q = torch.zeros((rows, HID), dtype=torch.int8, device=device)
        lib = time_ms(lambda: (torch._int_mm(x_q, wfc.T), torch._int_mm(h_q, wproj.T)), device,
                      iters)
        res["library_ms"] = lib
        print(f"_int_mm   {lib:9.4f} ms on the card (the two products alone, int32 out; a "
              f"yardstick of another function); {smi}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.rows, args.device, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
