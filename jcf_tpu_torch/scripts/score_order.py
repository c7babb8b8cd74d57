"""Measures the summation order that the attention kernels' bf16 bars
depend on, on one NVIDIA GPU.

    python3 -m jcf_tpu_torch.scripts.score_order            # the card
    python3 -m jcf_tpu_torch.scripts.score_order --device cpu --prompts 2 --seeds 1

On seeded bf16 qkv of the text tower's causal attention (P prompts x 77
tokens x 8 heads of 64; P = ``--prompts`` and a quarter of it at 1.5x
the scale), for each seed it prints:
- the share of the f32 scores ``torch.matmul(q, k^T)`` (the plain
  versions' product) equal to one fmaf after another over the 64 dims,
  and to the exactly rounded dot product;
- the elements of the bf16 context that ``causal_attention`` (the
  kernel on the card, its plain version on the CPU) and the context from
  exactly rounded scores each put past 1 bf16 ulp + 1e-3 of
  ``causal_attention_plain`` (the bar ``chip_smoke.py`` phase 4 holds
  the kernel to, with no slack for a p that rounds to bf16 across a tie).
"""

from __future__ import annotations

import argparse
import sys

import torch

from jcf_tpu_torch.ops import block_kernel as bk
from jcf_tpu_torch.scripts.common import card_line

S, HEADS, D = 77, 8, 64


def seq_fma(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q @ k^T as one fmaf after another over the last dim: f64 holds each
    step exactly (bf16 products, f32 sums), one f32 rounding a step."""
    acc = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float32, device=q.device)
    q64, k64 = q.double(), k.double()
    for d in range(q.shape[-1]):
        acc = (acc.double() + q64[..., d, None] * k64[..., None, :, d]).float()
    return acc


def over(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Elements past 1 bf16 ulp of the larger value + 1e-3."""
    g, r = got.float(), ref.float()
    return int(((g - r).abs() > 2.0**-7 * g.abs().maximum(r.abs()) + 1e-3).sum())


def context_from(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version's softmax and PV on given f32 scores [B, H, S, S]."""
    b = scores.shape[0]
    sc = scores * (1.0 / D**0.5) + bk.causal_mask(S, scores.device)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    ctx = torch.matmul(p.bfloat16().float(), v)
    return ctx.permute(0, 2, 1, 3).reshape(b * S, HEADS * D).bfloat16()


def run(device="cuda", prompts: int = 512, seeds: int = 6) -> list:
    """One line a (prompts, scale, seed) -> the list of the lines' dicts."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(device), flush=True)
    rows = []
    for b, scale in ((prompts, 1.0), (max(1, prompts // 4), 1.5)):
        for seed in range(seeds):
            g = torch.Generator(device=device).manual_seed(seed)
            qkv = (torch.randn(b * S, 3 * HEADS * D, device=device, generator=g) * scale).bfloat16()
            q, k, v = qkv.float().reshape(b, S, 3, HEADS, D).permute(2, 0, 3, 1, 4)
            st = torch.matmul(q, k.transpose(-1, -2))
            se = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
            ref = bk.causal_attention_plain(qkv, S, HEADS)
            row = {"prompts": b, "scale": scale, "seed": seed,
                   "matmul_eq_seq_fma": float((st == seq_fma(q, k)).float().mean()),
                   "matmul_eq_exact": float((st == se).float().mean()),
                   "kernel_over": over(bk.causal_attention(qkv, S, HEADS), ref),
                   "exact_scores_over": over(context_from(se, v), ref)}
            rows.append(row)
            print(f"{b} prompts x {S} x {HEADS}, x{scale}, seed {seed}: torch.matmul equals the "
                  f"sequential fmaf on {row['matmul_eq_seq_fma']:.6f} of the scores, the exactly "
                  f"rounded dot on {row['matmul_eq_exact']:.6f}; past 1 bf16 ulp + 1e-3 of "
                  f"causal_attention_plain: the kernel {row['kernel_over']}, exactly rounded "
                  f"scores {row['exact_scores_over']}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompts", type=int, default=512)
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args(argv)
    run(args.device, args.prompts, args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
