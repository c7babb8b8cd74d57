#!/usr/bin/env python3
"""Times the int8 whole-layer kernels K9a (``block_int8``) and K9d
(``layer_fused_int8``) on the folded dense route, one layer of the
seed-0 ViT-B/32 vision tower, on one NVIDIA GPU.

    python3 profile_k9.py [ROOT]   # from the repository root

Two modes at the shapes ``PERF.md`` reports them: "full+score" (static
LN, context and hidden scales and the softmax shift, from a fixed
calibration table) at 8192 crops x 50 rows (b1024 x 8 views), and the
dynamic mode at 4104 crops x 54 rows (jcf-predict's prompted tower: 8
images x 513 crops, 4 prompt tokens). Seeded bf16 rows. Prints the card
and, per kernel and mode, the ms per launch (CUDA events, the median of
``ROUNDS`` rounds of ``REPS`` launches). ``ROOT`` (default: this
script's directory) is the checkout whose ``jcf_tpu_torch`` is timed: to
compare two builds, run it on both checkouts on the same card,
alternating (A, B, B, A).
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADS = 12
# (mode, crops, rows a crop); the amax table's columns are
# vision_ln_z_amax's: LN1 and LN2 z-norm, context, hidden, score amax and
# the weakest row's score max
SHAPES = (("full+score", 8192, 50), ("dynamic", 4104, 54))
AMAX = (6.0, 6.0, 3.0, 4.0, 45.0, 2.0)
ROUNDS, REPS = 5, 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_k9: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT)
    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params, tree_to
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    print(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(bk.__file__)))}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    cfg = CLIPConfig(vision_layers=1, text_layers=1)
    params = tree_to(init_clip_params(0, cfg), dev)
    heads = {"visual": HEADS, "text": cfg.text_heads}
    trees = {
        "full+score": quantize_clip_params(
            params, fold=True, heads=heads,
            act_scales={"visual": torch.tensor([AMAX], device=dev)},
            act_static=("ctx", "hidden", "score"))["visual"],
        "dynamic": quantize_clip_params(params, fold=True, heads=heads)["visual"],
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    for mode, crops, s in SHAPES:
        layer = layer_slice(trees[mode], 0)
        x = torch.randn(crops * s, cfg.vision_width, device=dev, generator=gen).bfloat16()
        for name in ("block_int8", "layer_fused_int8"):
            fn = getattr(bk, name)
            report(f"{name} {mode} {crops} crops x {s} rows", lambda: fn(x, layer, s, HEADS))
        del x
    return 0


def report(label: str, fn) -> None:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    print(f"{label}: {statistics.median(times):.3f} ms per launch "
          f"(min {min(times):.3f}, max {max(times):.3f})")


if __name__ == "__main__":
    sys.exit(main())
