"""Probe P2 on an H100: the im2col regroup of 224² planes into 32² patch
rows, three ways.

Port of ``scripts/exp_patch_regroup.py``: ``out[i, py * 7 + px, dy * 32 +
dx] = x[i, py * 32 + dy, px * 32 + dx]`` for x [512, 224, 224] -> [512,
49, 1024], in f32 and in int8, with one kernel template
(``csrc/patch_regroup.cu``) for the TPU probe's three kernels: A
(``kernel_a``, reshape + transpose of a plane) a persistent block an SM
owning whole planes, each 32² tile one TMA box and each band one bulk
store, B (``kernel_b``, per 32-row band) a block a band, C
(``kernel_c``, strided rows ``x[dy::32]``) a block a (plane, dy). Each
is held to the plain version (``view`` / ``permute`` / ``reshape``) and
to the TPU probe's numpy check on plane 0, bit for bit, and timed with
CUDA events beside its bound (the bytes read and written once over
``PEAK_BYTES``) and beside the plain version's eager copy, the library
yardstick. The port does not call the regroup anywhere else: its patch
embedding reshapes in eager PyTorch, as the JAX engine runs a conv.

    python -m jcf_tpu_torch.scripts.exp_patch_regroup           # the card
    python -m jcf_tpu_torch.scripts.exp_patch_regroup --device cpu --planes 2
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.scripts.common import bound_ms, card_line, time_ms

SIDE, PATCH = 224, 32  # the probe's plane and patch (scripts/exp_patch_regroup.py:30)
PLANES = 512

STRATEGIES = {"a": 0, "b": 1, "c": 2}
NAMES = {"a": "A reshape+transpose", "b": "B per-py transpose", "c": "C strided rows"}
DTYPES = {"f32": torch.float32, "int8": torch.int8}
# launches of each strategy's kernel (CUDA tensors only)
LAUNCHES = {f"patch_regroup_{s}": 0 for s in STRATEGIES}


def patch_regroup_plain(x: torch.Tensor, patch: int = PATCH) -> torch.Tensor:
    """x [n, G*P, G*P] -> [n, G*G, P*P]: patch (py, px) as row py * G + px,
    its pixel (dy, dx) at column dy * P + dx."""
    n, h, w = x.shape
    g = h // patch
    return x.view(n, g, patch, g, patch).permute(0, 1, 3, 2, 4).reshape(n, g * g, patch * patch)


def patch_regroup(x: torch.Tensor, strategy: str, patch: int = PATCH) -> torch.Tensor:
    """As ``patch_regroup_plain``: for a CUDA tensor the kernel of
    ``strategy`` ("a", "b" or "c"), for a CPU tensor the plain version."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {sorted(STRATEGIES)}, got {strategy!r}")
    if not x.is_cuda:
        return patch_regroup_plain(x, patch)
    name = f"patch_regroup_{strategy}"
    if x.dim() != 3 or x.shape[1] != x.shape[2] or x.shape[1] % patch:
        raise ValueError(f"{name} takes square planes [n, G*P, G*P], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.int8) or (patch * x.element_size()) % 16:
        raise ValueError(f"{name} takes f32 or int8 planes with patch rows of 16-byte multiples, "
                         f"got {x.dtype} and patch {patch}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} takes a contiguous, 16-byte aligned tensor")
    n, side = x.shape[0], x.shape[1]
    g = side // patch
    out = torch.empty((n, g * g, patch * patch), dtype=x.dtype, device=x.device)
    err = _build.load().jcf_patch_regroup(x.data_ptr(), out.data_ptr(), n, g, patch,
                                          x.element_size(), STRATEGIES[strategy],
                                          _build.stream_ptr(x.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def numpy_reference(plane: np.ndarray, patch: int = PATCH) -> np.ndarray:
    """The TPU probe's check of one plane (scripts/exp_patch_regroup.py:77-78)."""
    g = plane.shape[0] // patch
    return plane.reshape(g, patch, g, patch).transpose(0, 2, 1, 3).reshape(g * g, patch * patch)


def planes(n: int, dtype: torch.dtype, device, seed: int = 0, side: int = SIDE) -> torch.Tensor:
    """Seeded planes [n, side, side]: standard normal in f32, every int8
    value in int8."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        x = rng.integers(-128, 128, (n, side, side)).astype(np.int8)
    else:
        x = rng.standard_normal((n, side, side), np.float32)
    return torch.from_numpy(x).to(device)


def run(n: int = PLANES, device="cuda", iters: int = 20, seed: int = 0) -> dict:
    """Each strategy in f32 and int8: checked bit for bit against the plain
    version and the numpy reference, timed; the plain copy timed beside
    them. One line each; returns {dtype: {strategy: ms, "plain": ms,
    "bound_ms": ms}}."""
    device = torch.device(device)
    smi = card_line(device)
    print(smi, flush=True)
    unit = "ms on the card" if device.type == "cuda" else "ms, host clock (CPU)"
    res = {}
    for tag, dt in DTYPES.items():
        x = planes(n, dt, device, seed)
        ref = patch_regroup_plain(x)
        ref0 = numpy_reference(x[0].cpu().numpy())
        n_bytes = 2 * x.numel() * x.element_size()  # read once, written once
        gb = n_bytes / 1e9
        r = res[tag] = {"bound_ms": bound_ms(n_bytes)[0]}
        print(f"--- {tag} ({n} planes; H100 bound {r['bound_ms']:.4f} ms, bytes)", flush=True)
        for s in STRATEGIES:
            out = patch_regroup(x, s)
            ok = torch.equal(out, ref) and np.array_equal(out[0].cpu().numpy(), ref0)
            if not ok:
                raise AssertionError(f"{NAMES[s]} ({tag}) differs from the plain version")
            ms = r[s] = time_ms(lambda: patch_regroup(x, s), device, iters)
            print(f"{NAMES[s]}: ok={ok} {ms:.4f} {unit} for {n} planes ({gb / (ms / 1e3):.0f} "
                  f"GB/s effective); {smi}", flush=True)
        ms = r["plain"] = time_ms(lambda: patch_regroup_plain(x), device, iters)
        print(f"plain (view/permute/reshape copy): {ms:.4f} {unit} ({gb / (ms / 1e3):.0f} GB/s "
              f"effective); {smi}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--planes", type=int, default=PLANES)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.planes, args.device, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
