#!/usr/bin/env python3
"""Times K3's attention kernel (``ops.block_kernel.attention``) at the
ViT-B/32 serving shapes, K6a's causal attention
(``causal_attention``) and K9b (``block_bf16``) on one text layer, on
one NVIDIA GPU.

    python3 profile_attention.py [ROOT]   # from the repository root

Seeded bf16 qkv rows of 12 heads of 64: 8192 crops of 50 tokens (224²,
b1024 x 8 views) with the int8 context (a static scale) and the f32
context (dynamic), and 2048 crops of 82 tokens (288², b256 x 8) with the
int8 context. K6a causal: bf16 qkv of 512 prompts x 77 tokens, 8 heads
of 64. K9b: seed-0 weights of the ViT-B/32 text tower's layer 0 on 512
prompts x 77 tokens (the classifier build's batch) with the causal
mask. Prints the card and, per kernel and shape, the ms per launch
(CUDA events, the median of ``ROUNDS`` rounds of ``REPS`` launches) on
one line each. ``ROOT`` (default: this script's directory) is the
checkout whose ``jcf_tpu_torch`` is timed: to compare two builds, run it
on both checkouts on the same card, alternating (A, B, B, A).
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADS, E = 12, 768
SHAPES = ((8192, 50, "int8"), (8192, 50, "f32"), (2048, 82, "int8"))
PROMPTS = 512  # K9b's text batch
ROUNDS, REPS = 7, 10


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT)
    from jcf_tpu_torch.ops import block_kernel as bk

    print(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(bk.__file__)))}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ctx_inv = torch.tensor([20.0], device=dev)
    for crops, s, out in SHAPES:
        qkv = (torch.randn(crops * s, 3 * E, device=dev, generator=gen) * 0.5).bfloat16()
        inv = ctx_inv if out == "int8" else None
        report(f"attention {crops} crops x S = {s}, {out} context",
               lambda: bk.attention(qkv, inv, s, HEADS))
        del qkv
    qkv = torch.randn(PROMPTS * 77, 3 * 512, device=dev, generator=gen).bfloat16()
    report(f"causal_attention {PROMPTS} prompts x S = 77, bf16",
           lambda: bk.causal_attention(qkv, 77, 8))
    del qkv

    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params, tree_to
    from jcf_tpu_torch.ops.attention import causal_mask
    from jcf_tpu_torch.ops.layers import layer_slice

    cfg = CLIPConfig(vision_layers=1, text_layers=1)
    layer = layer_slice(tree_to(init_clip_params(0, cfg)["text"]["blocks"], dev), 0)
    s = cfg.context_length
    x = torch.randn(PROMPTS * s, cfg.text_width, device=dev, generator=gen).bfloat16()
    bias = causal_mask(s, dev)
    report(f"block_bf16 {PROMPTS} prompts x S = {s}, causal",
           lambda: bk.block_bf16(x, layer, s, cfg.text_heads, bias))
    return 0


def report(label: str, launch) -> None:
    """Prints the median, min and max ms per launch of ``launch`` over
    ``ROUNDS`` rounds of ``REPS`` launches, after one warm-up."""
    import torch

    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    print(f"{label}: median {statistics.median(times):.4f} ms per launch, min {min(times):.4f}, "
          f"max {max(times):.4f} ({ROUNDS} x {REPS})")


if __name__ == "__main__":
    sys.exit(main())
