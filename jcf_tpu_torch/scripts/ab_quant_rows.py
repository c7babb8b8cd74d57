"""Times the dynamic int8 row quantization (``quant_rows``, with and
without QuickGELU) and K2 (``assemble_dense_rows``) at the shapes the int8
paths run, for an A/B of two checkouts on one NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_quant_rows.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_quant_rows.py --device cpu --scale 512 --rounds 1 --reps 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

Seeded f32 rows (normal x 3, every 97th row zero) through
``ops.block_kernel.quant_rows`` at the context's width and, with
``gelu=True``, the hidden's: ViT-B/32 at 8192 crops x 50 (409,600 x 768
and x 3072), its last layer's CLS rows (8192), ``features_from_crops``
at 4104 crops x 50 (205,200), the int8 text tower at 512 prompts x 77
(39,424 x 512 and x 2048) and the 3-head tower at 1024 crops x 50
(51,200 x 192 and x 768); seeded int32 accumulators through
``ops.assemble_kernel.assemble_dense_rows`` at 8192 crops of 7 x 7
patches and 2048 of 9 x 9 (288²), E = 768. Each line prints the median,
min and max ms per launch over ``--rounds`` rounds of ``--reps`` launches
(CUDA events; on the CPU the host clock, where the wrappers run their
plain versions), on the card also the median of ``--reps`` launches
captured in one CUDA graph (the device time without the wrapper's host
time, which the smallest shapes' eager medians measure), the bytes bound
at 3.35 TB/s, the launch counts by route
where the checkout has them, and the SHA-256 of every output (the int8
values and the scales; K2's rows). ``--scale`` divides every row count.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
PEAK_BYTES = 3.35e12  # one H100 SXM's HBM3 rate (NVIDIA's data sheet)
# (label, rows, context width, hidden width)
ROW_SHAPES = (
    ("ViT-B/32, 8192 crops x 50", 409600, 768, 3072),
    ("ViT-B/32 CLS rows, 8192", 8192, 768, 3072),
    ("features_from_crops, 4104 crops x 50", 205200, 768, 3072),
    ("text tower, 512 x 77", 39424, 512, 2048),
    ("3-head tower, 1024 crops x 50", 51200, 192, 768),
)
# (label, crops, patch grid side, width)
ASSEMBLE_SHAPES = (("224², 8192 crops x 7 x 7", 8192, 7, 768),
                   ("288², 2048 crops x 9 x 9", 2048, 9, 768))


def _ab_gemm():
    """This checkout's ``ab_gemm.py`` (its ``import_package`` and
    ``report``), loaded by path before any ``jcf_tpu_torch`` is imported."""
    spec = importlib.util.spec_from_file_location("_ab_gemm", os.path.join(HERE, "ab_gemm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sha(*tensors) -> str:
    """SHA-256 (first 16 hex digits) of the tensors' bytes in turn."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def first(out):
    return out[0] if isinstance(out, tuple) else out


def run(root: str = ROOT, device="cuda", scale: int = 1, rounds: int = 7, reps: int = 10) -> dict:
    """Times every line of the list above from ``root``'s package ->
    {label: median ms}."""
    ab = _ab_gemm()
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = ab.import_package(root)
    from jcf_tpu_torch.ops import assemble_kernel as ak
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.scripts.common import card_line

    print(card_line(device), flush=True)
    print(f"package: {package}", flush=True)
    res = {}

    def timed(label, launch, n_bytes, counters, names):
        out = launch()
        outs = out if isinstance(out, tuple) else (out,)
        print(f"{label}: sha256 {sha(*outs)}, bound {n_bytes / PEAK_BYTES * 1e3:.4f} ms (bytes)",
              flush=True)
        del out, outs
        before = dict(counters)
        res[label] = ab.report(label, lambda: first(launch()), device, rounds, reps)
        if device.type == "cuda":
            res[label + " (graph)"] = ab.graph_ms(label, launch, device, rounds, reps)
        routes = {k: counters[k] - before[k] for k in counters
                  if k.split("/")[0] in names and counters[k] != before[k]}
        print(f"{label}: launches {routes}", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    for tag, rows, ctx_n, hid_n in ROW_SHAPES:
        m = max(1, rows // scale)
        for n, gelu in ((ctx_n, False), (hid_n, True)):
            name = "gelu_quant_rows" if gelu else "quant_rows"
            x = torch.randn(m, n, device=device, generator=gen) * 3
            x[::97] = 0.0
            timed(f"{name} {tag}: {m} x {n}", lambda: bk.quant_rows(x, gelu=gelu),
                  m * n * 5 + m * 4, bk.LAUNCHES, (name,))
            del x
            if device.type == "cuda":
                torch.cuda.empty_cache()
    for tag, crops, side, e in ASSEMBLE_SHAPES:
        b = max(1, crops // scale)
        n_tok = side * side
        acc = torch.randint(-20000, 20000, (b, side, side, e), device=device, generator=gen,
                            dtype=torch.int32)
        col_scale = torch.rand(e, device=device, generator=gen) * 1e-4
        col_bias = torch.randn(e, device=device, generator=gen)
        pos = torch.randn(n_tok, e, device=device, generator=gen).bfloat16()
        lns = 1 + 0.1 * torch.randn(e, device=device, generator=gen)
        lnb = 0.1 * torch.randn(e, device=device, generator=gen)
        cls = ak.make_cls_row(torch.randn(e, device=device, generator=gen), pos[0], lns, lnb)
        args = (acc, col_scale, col_bias, pos, cls, lns, lnb)
        n_bytes = acc.numel() * 4 + b * (n_tok + 1) * e * 2 + n_tok * e * 2 + 4 * e * 4 + e * 2
        timed(f"assemble {tag}: {b * n_tok} x {e} -> {b * (n_tok + 1)} rows",
              lambda: ak.assemble_dense_rows(*args), n_bytes, ak.LAUNCHES, ("assemble",))
        got, ref = ak.assemble_dense_rows(*args).float(), ak.assemble_dense_rows_plain(*args).float()
        bar = 2.0**-7 * got.abs().maximum(ref.abs()) + 1e-3
        print(f"assemble {tag}: vs plain max |diff| {float((got - ref).abs().max()):.3e}, "
              f"over the bf16 bar {int(((got - ref).abs() > bar).sum())}, elements differing "
              f"{int((got != ref).sum())} of {got.numel()}", flush=True)
        del acc, args, got, ref, bar
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1, help="divides every row and crop count")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.root, args.device, args.scale, args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
