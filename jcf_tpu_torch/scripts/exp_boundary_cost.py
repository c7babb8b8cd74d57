"""Probe P4 on an H100: what one kernel boundary costs.

Port of ``scripts/exp_boundary_cost.py``: chains of n = 6, 12, 24 and 48
launches of ``copy_add_one`` (o = x + 1 in bf16, the counterpart of the
TPU probe's ``copy_kernel``) over the serving row stream [204800, 768],
each launch reading its predecessor's output. Each chain is timed with
CUDA events two ways: launched eagerly on one stream, and captured in one
CUDA graph (the counterpart of ``jax.jit`` running the chain as one
executable). The least-squares slope of ms per chain over n is the time
of one kernel in a chain; less the kernel's memory bound (2 x 314.6 MB
over ``PEAK_BYTES``, about 0.19 ms) it is the boundary's cost: what fusing
two kernels into one launch saves at most. Every chain's output is held
to the plain chain's bit for bit (the mean delta printed beside it).

    python -m jcf_tpu_torch.scripts.exp_boundary_cost            # the card
    python -m jcf_tpu_torch.scripts.exp_boundary_cost --device cpu --rows 64 --width 32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.scripts.common import PEAK_BYTES, card_line, time_ms

# launches of copy_add_one's kernel (CUDA tensors only)
LAUNCHES = {"copy_add_one": 0}

LENGTHS = (6, 12, 24, 48)


def copy_add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``copy_add_one``: x + 1 in bf16."""
    return x + 1


def copy_add_one(x: torch.Tensor) -> torch.Tensor:
    """bf16 x (contiguous, a multiple of 8 elements) -> x + 1 in a new
    tensor: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if not x.is_cuda:
        return copy_add_one_plain(x)
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.numel() % 8:
        raise ValueError(f"copy_add_one takes contiguous bf16 with a multiple of 8 elements, "
                         f"got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    err = _build.load().jcf_copy_add_one(x.data_ptr(), out.data_ptr(), x.numel(),
                                         _build.stream_ptr(x.device))
    _build.check(err, "copy_add_one")
    LAUNCHES["copy_add_one"] += 1
    return out


def chain(x: torch.Tensor, n: int, fn=copy_add_one) -> torch.Tensor:
    for _ in range(n):
        x = fn(x)
    return x


def graph_chain(x: torch.Tensor, n: int):
    """The chain of n launches on ``x`` captured in one CUDA graph ->
    (replay, output tensor the replay writes)."""
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        chain(x, n)  # warm the allocator outside the capture
    torch.cuda.current_stream(x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain(x, n)
    return graph.replay, out


def fit(ns, ms):
    """Least-squares (slope, intercept) of ms over n."""
    slope, intercept = np.polyfit(np.asarray(ns, np.float64), np.asarray(ms, np.float64), 1)
    return float(slope), float(intercept)


def run(rows: int = 204800, width: int = 768, lengths=LENGTHS, device="cuda", iters: int = 10,
        seed: int = 0) -> dict:
    """Times the chains and prints one line per n and the fit; returns the
    numbers (ms per chain by n, eager and graph; the fits; the bound)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    print(card_line(device), flush=True)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, width),
                                                                     np.float32))
    x = x.to(device=device, dtype=torch.bfloat16)
    n_bytes = 2 * x.numel() * x.element_size()  # one launch: read x, write o
    bound = n_bytes / PEAK_BYTES * 1e3
    res = {"rows": rows, "width": width, "bytes_per_kernel": n_bytes, "bound_ms": bound,
           "eager_ms": {}, "graph_ms": {}, "delta": {}}
    for n in lengths:
        out = chain(x, n)
        ref = chain(x, n, copy_add_one_plain)
        if not torch.equal(out, ref):
            raise AssertionError(f"n={n}: the kernel chain differs from the plain chain")
        delta = float((out.float() - x.float()).mean())
        res["delta"][n] = delta
        eager = time_ms(lambda: chain(x, n), device, iters)
        res["eager_ms"][n] = eager
        line = (f"n={n:3d}: eager {eager:9.3f} ms/chain ({eager / n:.4f} ms/kernel, "
                f"{n_bytes / (eager / n * 1e-3) / 1e9:.0f} GB/s)")
        if on_card:
            replay, g_out = graph_chain(x, n)
            replay()
            if not torch.equal(g_out, ref):
                raise AssertionError(f"n={n}: the graph chain differs from the plain chain")
            graph = time_ms(replay, device, iters)
            res["graph_ms"][n] = graph
            line += (f" | graph {graph:9.3f} ms/chain ({graph / n:.4f} ms/kernel, "
                     f"{n_bytes / (graph / n * 1e-3) / 1e9:.0f} GB/s)")
            del replay, g_out
        print(f"{line} | mean delta {delta:.4f} (equal to the plain chain's)", flush=True)
    res["eager_fit"] = fit(lengths, [res["eager_ms"][n] for n in lengths])
    if on_card:
        res["graph_fit"] = fit(lengths, [res["graph_ms"][n] for n in lengths])
    print(f"H100 memory bound per kernel: 2 x {n_bytes / 2 / 1e6:.1f} MB / {PEAK_BYTES / 1e12:.2f} "
          f"TB/s = {bound:.4f} ms", flush=True)
    for kind in ("eager", "graph"):
        if f"{kind}_fit" not in res:
            print(f"{kind}: not measured (no card)")
            continue
        slope, intercept = res[f"{kind}_fit"]
        print(f"{kind}: slope {slope:.4f} ms/kernel, intercept {intercept:.4f} ms; boundary "
              f"overhead (slope - bound) {slope - bound:.4f} ms", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=204800)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--lengths", default=",".join(map(str, LENGTHS)))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.rows, args.width, tuple(int(n) for n in args.lengths.split(",")), args.device,
        args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
