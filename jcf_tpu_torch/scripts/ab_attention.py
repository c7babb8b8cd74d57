"""Times the port's attention kernels at their main paths' shapes, for an
A/B of two checkouts on one NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_attention.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_attention.py --device cpu --crops 1 --rounds 1 --reps 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

Seeded inputs, ``--crops`` N (default 2048, b256 x 8 views):
- K8 (``ops.attention.fused_attention``) in bf16 and f32 on head views of
  a packed qkv [N, 197, 3 x 768] (ViT-B/16 serving: N crops x 12 heads),
  and in f32 at N/8 crops x 16 heads x 577 tokens (ViT-L/14@336px);
- the mask-free pair attention (``ops.block_kernel.pair_attention``) in
  bf16 and f32 at 4N crops x 50 tokens x 12 heads (the float ViT-B/32
  towers at b1024 x 8 views);
- K3's ``attention`` at 4N x 50 with the int8 context (a static scale),
  with the calibrated shift ("+score"), with the f32 context
  (``attention_f32``, dynamic) and with the f32 context of the unfolded
  tree (``attention_scaled_f32``, the scores x 1/8); and at N crops x 82
  tokens (288² crops) with the int8 context;
- probe P3's ``batched_dot_mma`` at 6N heads of [56, 64];
- the masked attention (``ops.block_kernel.masked_attention``) on bf16
  qkv at N/4 prompts x 77 tokens x 8 heads, causal, the scores x 1/8
  (the text towers at 512 prompts): the f32 context
  (``masked_attention_f32``), the int8 context (``masked_attention``)
  and the bf16 one (``causal_attention``), and ``causal_attention_f32``
  on the same rows in f32; and at N/2 crops x 50 tokens x 3 heads without
  a mask (``head_attention``, the odd-head float tower at 1024 crops), in
  bf16 and in f32 (``head_attention_f32``);
- K7 (``ops.attention.packed_attention_fwd`` / ``_bwd``) in bf16 and f32
  at the stage-1 step's attention shapes scaled by N / 2048: the text
  tower's 403 x 77 x 8 heads under the causal mask, the vision tower's
  256 x 50 x 12 heads with a zero bias.
Each prints the median, min and max ms per launch over ``--rounds``
rounds of ``--reps`` launches (CUDA events; on the CPU the host clock,
where the wrappers run their plain versions) and a checksum of the
output, so that the two sides show whether an unchanged kernel still
computes the same bits.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
HEADS, D = 12, 64
E = HEADS * D


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


def report(label: str, launch, device, rounds: int, reps: int) -> float:
    """Prints the median, min and max ms per launch of ``launch`` over
    ``rounds`` rounds of ``reps`` launches, after one warm-up, and the
    output's checksum -> the median."""
    import torch

    out = launch()
    checksum = float(out.float().sum())
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
          f"({rounds} x {reps}), checksum {checksum:.6e}", flush=True)
    return med


def run(root: str = ROOT, device="cuda", crops: int = 2048, rounds: int = 7,
        reps: int = 10) -> dict:
    """Times every kernel of the list above from ``root``'s package ->
    {label: median ms}."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = import_package(root)
    from jcf_tpu_torch.ops import attention as at
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.scripts import exp_batched_dot as p3
    from jcf_tpu_torch.scripts.common import card_line

    print(card_line(device), flush=True)
    print(f"package: {package}", flush=True)

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    res = {}

    def timed(label, launch):
        res[label] = report(label, launch, device, rounds, reps)

    qkv = torch.randn(crops, 197, 3 * E, device=device, generator=gen)
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = qkv.to(dtype).unflatten(-1, (3, HEADS, D)).permute(2, 0, 3, 1, 4)
        timed(f"K8 blocked_attention {name}, {crops} x {HEADS} x 197",
              lambda: at.fused_attention(q, k, v))
        del q, k, v
    del qkv
    n_long = max(1, crops // 8)
    qkv = torch.randn(n_long, 577, 3 * 16 * D, device=device, generator=gen)
    q, k, v = qkv.unflatten(-1, (3, 16, D)).permute(2, 0, 3, 1, 4)
    timed(f"K8 blocked_attention f32, {n_long} x 16 x 577", lambda: at.fused_attention(q, k, v))
    del qkv, q, k, v
    s, pair_crops = 50, 4 * crops
    qkv = torch.randn(pair_crops * s, 3 * E, device=device, generator=gen) * 0.5
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        rows = qkv.to(dtype)
        timed(f"pair_attention {name}, {pair_crops} x {s}",
              lambda: bk.pair_attention(rows, s, HEADS))
        del rows
    rows = qkv.bfloat16()
    del qkv
    ctx_inv = torch.tensor([20.0], device=device)
    timed(f"K3 attention (int8 context), {pair_crops} x {s}",
          lambda: bk.attention(rows, ctx_inv, s, HEADS))
    shift = torch.tensor([[6.0]], device=device)
    timed(f"K3 attention +score (int8 context, shift), {pair_crops} x {s}",
          lambda: bk.attention(rows, ctx_inv, s, HEADS, shift))
    timed(f"K3 attention_f32 (f32 context), {pair_crops} x {s}",
          lambda: bk.attention(rows, None, s, HEADS))
    timed(f"K3 attention_scaled_f32 (f32 context, unfolded), {pair_crops} x {s}",
          lambda: bk.attention(rows, None, s, HEADS, scale=0.125))
    del rows
    s = 82
    rows = (torch.randn(crops * s, 3 * E, device=device, generator=gen) * 0.5).bfloat16()
    timed(f"K3 attention (int8 context), {crops} x {s}",
          lambda: bk.attention(rows, ctx_inv, s, HEADS))
    del rows
    heads = 6 * crops
    q, k, v = p3.inputs(heads, device)
    timed(f"batched_dot_mma, {heads} heads x {p3.S}", lambda: p3.batched_dot_mma(q, k, v))
    del q, k, v

    prompts, s, th = max(1, crops // 4), 77, 8
    qkv = (torch.randn(prompts * s, 3 * th * D, device=device, generator=gen) * 1.5).bfloat16()
    kw = dict(causal=True, scale=1.0 / 8.0)
    ctx_inv = torch.tensor([[20.0]], device=device)
    timed(f"masked_attention_f32 (f32 context), {prompts} x {s} x {th}, causal",
          lambda: bk.masked_attention(qkv, s, th, f32_ctx=True, **kw))
    timed(f"masked_attention (int8 context), {prompts} x {s} x {th}, causal",
          lambda: bk.masked_attention(qkv, s, th, ctx_inv=ctx_inv, **kw))
    timed(f"causal_attention bf16, {prompts} x {s} x {th}",
          lambda: bk.masked_attention(qkv, s, th, **kw))
    q32 = qkv.float()
    timed(f"causal_attention_f32, {prompts} x {s} x {th}",
          lambda: bk.masked_attention(q32, s, th, **kw))
    del qkv, q32
    n3, s = max(1, crops // 2), 50
    qkv = (torch.randn(n3 * s, 3 * 3 * D, device=device, generator=gen) * 1.5).bfloat16()
    timed(f"head_attention bf16, {n3} x {s} x 3",
          lambda: bk.masked_attention(qkv, s, 3, causal=False, scale=1.0 / 8.0))
    q32 = qkv.float()
    timed(f"head_attention_f32, {n3} x {s} x 3",
          lambda: bk.masked_attention(q32, s, 3, causal=False, scale=1.0 / 8.0))
    del qkv, q32

    for tower, b, s, h, causal in (("text", max(1, crops * 403 // 2048), 77, 8, True),
                                   ("vision", max(1, crops // 8), 50, 12, False)):
        bias = at.causal_mask(s, device) if causal else torch.zeros(s, s, device=device)
        qkv = torch.randn(b, s, 3 * h * D, device=device, generator=gen)
        dout = torch.randn(b, s, h * D, device=device, generator=gen)
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, dx = qkv.to(dtype), dout.to(dtype)
            timed(f"K7 forward {name} {tower}, {b} x {s} x {h}",
                  lambda: at.packed_attention_fwd(x, h, bias))
            timed(f"K7 backward {name} {tower}, {b} x {s} x {h}",
                  lambda: at.packed_attention_bwd(x, h, bias, dx))
        del qkv, dout, x, dx
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crops", type=int, default=2048, help="ViT-B/16 crops (x 4 for S = 50)")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.root, args.device, args.crops, args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
