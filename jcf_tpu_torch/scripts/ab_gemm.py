"""Times every epilogue of the port's int8 GEMM at its serving shapes, and
the float towers' bf16 and f32 GEMMs, for an A/B of two checkouts on one
NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_gemm.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_gemm.py --device cpu --crops 2 --rounds 1 --reps 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

Seeded int8 operands, ``--crops`` N (default 8192: ViT-B/32 at b1024 x 8
views), and the ``ops.int8_gemm`` wrapper that each caller uses:
- the patch embed (``int8_gemm_s32``): 49N x 3072 -> 768;
- K3's qkv (``int8_gemm_bf16``, static and with row scales): 50N x 768
  -> 2304; out-proj (``int8_gemm_residual``, bf16): 50N x 768 -> 768;
- K4's c_fc (``int8_gemm_gelu_quant``; ``int8_gemm_f32`` with and
  without row scales): 50N x 768 -> 3072; c_proj (``int8_gemm_residual``,
  static and with row scales): 50N x 3072 -> 768;
- the ViT-B/16 row-scale linear (``int8_gemm_rowscale``) at 197 N/4 rows:
  qkv 768 -> 2304, c_fc 768 -> 3072;
- the f32 int8 text tower (``int8_gemm_residual`` on an f32 residual,
  with row scales, and without) at N/16 prompts x 77 tokens: c_proj 2048
  -> 512, out-proj 512 -> 512;
- probe P1's int4-weight GEMMs (``csrc/w4a8.cu``, which keeps the
  mma.sync product): c_fc and c_proj at 50N rows;
- each of the qkv, c_fc and c_proj products again under five epilogues
  (s32, bf16, f32, GELU-quant, bf16 residual), whichever its callers
  use: the same int32 sums stored five ways, so the difference between
  two lines is what one epilogue costs beside another (s32 at these N
  takes the 256-column tile, the others 128);
- the float towers' GEMMs (``ops.bf16_gemm``, ``ops.f32_gemm``; seeded
  normal operands, their own generator) at the text shapes (N/16 prompts
  x 77 tokens, width 512) and the vision shapes (50N rows, width 768):
  qkv (bias epilogue), out-proj and c_proj (residual), c_fc (QuickGELU);
  the f32 GEMMs read the weight's TF32 planes, split before the timing,
  where the checkout takes them (``planes=``) and split the weight in each
  call where it does not; then the f32 GEMM's weight split (``tf32_split``,
  where the checkout has it) at c_fc's 3072 x 768, eager and, on the card,
  in a CUDA graph (its eager time is mostly the wrapper's host time).
Each prints the median, min and max ms per launch over ``--rounds``
rounds of ``--reps`` launches (CUDA events; on the CPU the host clock,
where the wrappers run their plain versions) and the SHA-256 of the
output's bytes, which two checkouts computing the same bits share.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
E, HID, TEXT_E = 768, 3072, 512


def import_package(root: str):
    """Imports ``jcf_tpu_torch`` from ``root`` -> its directory; raises if
    another checkout's is already imported."""
    root = os.path.abspath(root)
    loaded = sys.modules.get("jcf_tpu_torch")
    if loaded is not None:
        where = os.path.dirname(os.path.dirname(os.path.abspath(loaded.__file__)))
        if where != root:
            raise RuntimeError(f"jcf_tpu_torch is already imported from {where}, not {root}: "
                               "run this script as a file")
    else:
        sys.path.insert(0, root)
    import jcf_tpu_torch

    return os.path.dirname(os.path.abspath(jcf_tpu_torch.__file__))


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (first 16 hex digits)."""
    import torch

    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def report(label: str, launch, device, rounds: int, reps: int) -> float:
    """Prints the median, min and max ms per launch of ``launch`` over
    ``rounds`` rounds of ``reps`` launches, after one warm-up, and the
    output's digest -> the median."""
    import torch

    out = launch()
    sha = digest(out)
    del out
    times = []
    for _ in range(rounds):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                launch()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                launch()
            times.append((time.perf_counter() - t0) / reps * 1e3)
    med = statistics.median(times)
    print(f"{label}: median {med:.4f} ms per launch, min {min(times):.4f}, max {max(times):.4f} "
          f"({rounds} x {reps}), sha256 {sha}", flush=True)
    return med


def graph_ms(label: str, launch, device, rounds: int, reps: int) -> float:
    """The device time of ``launch``: ``reps`` launches captured in one
    CUDA graph, replayed ``rounds`` times -> the median ms per launch,
    printed."""
    import torch

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        launch()  # warm the allocator outside the capture
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    med = statistics.median(times)
    print(f"{label}: in a CUDA graph median {med:.4f} ms per launch, min {min(times):.4f}, max "
          f"{max(times):.4f} ({rounds} x {reps})", flush=True)
    return med


def run(root: str = ROOT, device="cuda", crops: int = 8192, rounds: int = 7,
        reps: int = 10) -> dict:
    """Times every GEMM of the list above from ``root``'s package ->
    {label: median ms}."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = import_package(root)
    from jcf_tpu_torch.scripts.common import card_line

    print(card_line(device), flush=True)
    print(f"package: {package}", flush=True)

    res = {}

    def timed(label, launch):
        res[label] = report(label, launch, device, rounds, reps)

    int8_rows(timed, device, crops)
    float_rows(timed, device, crops)
    return res


def int8_rows(timed, device, crops: int) -> None:
    """The int8 GEMMs' lines."""
    import numpy as np
    import torch

    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import int8_gemm as ig
    from jcf_tpu_torch.scripts import exp_w4a8 as p1

    gen = torch.Generator(device=device).manual_seed(0)

    def i8(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=device, generator=gen)

    def f32(*shape, lo=0.5, hi=1.5):
        return torch.rand(*shape, device=device, generator=gen) * (hi - lo) + lo

    rows = 50 * crops
    x_e, x_h = i8(rows, E), i8(rows, HID)
    w_qkv, w_out, w_fc, w_proj = i8(3 * E, E), i8(E, E), i8(HID, E), i8(E, HID)
    row_sc = f32(rows) * 1e-2
    resid = torch.randn(rows, E, device=device, generator=gen).bfloat16()

    def sb(n, scale=1e-3):
        return f32(n) * scale, torch.randn(n, device=device, generator=gen) * 0.1

    cols = i8(49 * crops, 3 * 32 * 32)
    timed(f"s32 patch embed, {49 * crops} x 3072 -> 768", lambda: ig.int8_gemm_s32(cols, w_proj))
    del cols
    sc, bi = sb(3 * E)
    timed(f"bf16 qkv, {rows} x 768 -> 2304", lambda: ig.int8_gemm_bf16(x_e, w_qkv, sc, bi))
    timed(f"bf16_rows qkv, {rows} x 768 -> 2304",
          lambda: ig.int8_gemm_bf16(x_e, w_qkv, sc, bi, row_scale=row_sc))
    sc, bi = sb(E)
    timed(f"residual out-proj, {rows} x 768 -> 768",
          lambda: ig.int8_gemm_residual(x_e, w_out, sc, bi, resid))
    timed(f"residual c_proj, {rows} x 3072 -> 768",
          lambda: ig.int8_gemm_residual(x_h, w_proj, sc, bi, resid))
    timed(f"residual_rows c_proj, {rows} x 3072 -> 768",
          lambda: ig.int8_gemm_residual(x_h, w_proj, sc, bi, resid, row_scale=row_sc))
    sc, bi = sb(HID, 3e-4)
    gelu_c = torch.tensor(bk.GELU_TANH_COEF, device=device)
    timed(f"gelu_quant c_fc, {rows} x 768 -> 3072",
          lambda: ig.int8_gemm_gelu_quant(x_e, w_fc, sc, bi, gelu_c))
    timed(f"f32 c_fc, {rows} x 768 -> 3072", lambda: ig.int8_gemm_f32(x_e, w_fc, sc, bi))
    timed(f"f32_rows c_fc, {rows} x 768 -> 3072",
          lambda: ig.int8_gemm_f32(x_e, w_fc, sc, bi, row_scale=row_sc))
    rng = np.random.default_rng(0)
    wfc4 = p1.pack(rng.integers(-7, 8, (HID, E)).astype(np.int8)).to(device)
    wproj4 = p1.pack(rng.integers(-7, 8, (E, HID)).astype(np.int8)).to(device)
    timed(f"w4a8 gelu_quant c_fc, {rows} x 768 -> 3072",
          lambda: p1.w4a8_gemm_gelu_quant(x_e, wfc4, sc, bi, gelu_c))
    sc, bi = sb(E)
    timed(f"w4a8 residual c_proj, {rows} x 3072 -> 768",
          lambda: p1.w4a8_gemm_residual(x_h, wproj4, sc, bi, resid))
    del resid, wfc4, wproj4

    rows16 = 197 * max(1, crops // 4)
    x16, rs16 = i8(rows16, E), f32(rows16) * 1e-2
    for name, w in (("qkv", w_qkv), ("c_fc", w_fc)):
        sc, bi = sb(w.shape[0])
        timed(f"rowscale {name}, {rows16} x 768 -> {w.shape[0]}",
              lambda: ig.int8_gemm_rowscale(x16, w, rs16, sc, bi))
    del x16

    rows_t = 77 * max(1, crops // 16)
    r32 = torch.randn(rows_t, TEXT_E, device=device, generator=gen)
    rs_t = f32(rows_t) * 1e-2
    sc, bi = sb(TEXT_E)
    for name, k in (("c_proj", 4 * TEXT_E), ("out-proj", TEXT_E)):
        x_t, w_t = i8(rows_t, k), i8(TEXT_E, k)
        timed(f"residual_f32 {name}, {rows_t} x {k} -> {TEXT_E}",
              lambda: ig.int8_gemm_residual(x_t, w_t, sc, bi, r32))
        timed(f"residual_f32_rows {name}, {rows_t} x {k} -> {TEXT_E}",
              lambda: ig.int8_gemm_residual(x_t, w_t, sc, bi, r32, row_scale=rs_t))
    del x_t, r32

    # each product under five epilogues, after the lines above have drawn
    # their operands
    for name, x, w in (("qkv", x_e, w_qkv), ("c_fc", x_e, w_fc), ("c_proj", x_h, w_proj)):
        n, k = w.shape
        sc, bi = sb(n, 3e-4)
        res_n = torch.randn(rows, n, device=device, generator=gen).bfloat16()
        for epi, launch in (("s32", lambda: ig.int8_gemm_s32(x, w)),
                            ("bf16", lambda: ig.int8_gemm_bf16(x, w, sc, bi)),
                            ("f32", lambda: ig.int8_gemm_f32(x, w, sc, bi)),
                            ("gelu_quant", lambda: ig.int8_gemm_gelu_quant(x, w, sc, bi, gelu_c)),
                            ("residual", lambda: ig.int8_gemm_residual(x, w, sc, bi, res_n))):
            timed(f"{epi} on the {name} product, {rows} x {k} -> {n}", launch)
        del res_n
    del x_e, x_h


def float_rows(timed, device, crops: int) -> None:
    """The bf16 and f32 GEMMs' lines at the text and vision shapes, then
    the weight split."""
    import torch

    from jcf_tpu_torch.ops import bf16_gemm as bg
    from jcf_tpu_torch.ops import f32_gemm as fg

    gen = torch.Generator(device=device).manual_seed(1)
    shapes = (("text", 77 * max(1, crops // 16), TEXT_E), ("vision", 50 * crops, E))
    for dtype, mod, tag in ((torch.bfloat16, bg, "bf16"), (torch.float32, fg, "f32")):
        for tower, rows, e in shapes:
            for name, k, n, epi in (("qkv", e, 3 * e, "bias"), ("out-proj", e, e, "residual"),
                                    ("c_fc", e, 4 * e, "gelu"), ("c_proj", 4 * e, e, "residual")):
                x = torch.randn(rows, k, device=device, generator=gen).to(dtype)
                w = (torch.randn(n, k, device=device, generator=gen) * k**-0.5).to(dtype)
                bias = torch.randn(n, device=device, generator=gen) * 0.1
                fn = getattr(mod, f"{tag}_gemm_{epi}")
                kw = ({"planes": fg.tf32_split(w)}
                      if dtype == torch.float32 and hasattr(fg, "with_tf32_planes") else {})
                if epi == "residual":
                    resid = torch.randn(rows, n, device=device, generator=gen).to(dtype)
                    launch = lambda: fn(x, w, bias, resid, **kw)  # noqa: E731
                else:
                    launch = lambda: fn(x, w, bias, **kw)  # noqa: E731
                timed(f"{tag}_gemm_{epi} {tower} {name}, {rows} x {k} -> {n}", launch)
                del x, launch, kw
    if hasattr(fg, "tf32_split"):
        w = torch.randn(4 * E, E, device=device, generator=gen) * E**-0.5
        label = f"tf32_split c_fc weights, {4 * E} x {E}"
        timed(label, lambda: fg.tf32_split(w))
        if device.type == "cuda":
            graph_ms(label, lambda: fg.tf32_split(w), device, 7, 10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crops", type=int, default=8192, help="ViT-B/32 crops (x 50 rows)")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.root, args.device, args.crops, args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
