"""Probe P5 on an H100: K3 and K4 timed apart.

Port of what ``scripts/profile_halves.py`` measures on the TPU: the
int8 attention half (K3, ``ops.block_kernel.attn_half_int8``) and the
int8 MLP half (K4, ``mlp_half_int8``) of the seed-0 ViT-B/32's layer 0,
on the unfolded tree (the LN affine, ``ln=``) with dynamic per-row scales,
each timed alone with CUDA events on 1024 crops x 50 tokens of bf16 rows.
Each half's bound is the larger of its bytes over ``PEAK_BYTES`` and its
operations over the peak of their type (the int8 GEMMs at ``PEAK_INT8``,
the attention's products at ``PEAK_BF16``). Each half splits into its
stages (the ``block_kernel`` functions in ``STAGES``, one kernel each),
timed with CUDA events around each stage of one call: ``torch.profiler``
showed no device time for these launches on the card.

Two arguments of the TPU script do not carry over. The TPU kernels pad
each crop's 50 rows to 56 and mask keys 50-55 with an additive bias; the
port keeps 50 rows a crop and its attention reads only those, so there is
no pad to time (``tests/test_torch_probes.py`` holds the unpadded halves
to the padded, masked ones in interpret mode). ``group`` (crops per grid
step) is the TPU kernels' tiling; the port's kernels tile themselves.

    python -m jcf_tpu_torch.scripts.profile_halves                 # the card
    python -m jcf_tpu_torch.scripts.profile_halves --device cpu --crops 2 --width 128
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from jcf_tpu_torch.models.clip import VIT_B_32, init_clip_params, tree_to
from jcf_tpu_torch.ops import block_kernel as bk
from jcf_tpu_torch.ops.layers import layer_slice
from jcf_tpu_torch.ops.quant import quantize_clip_params
from jcf_tpu_torch.scripts.common import (PEAK_BF16, PEAK_BYTES, PEAK_INT8, card_line,
                                          time_ms)

TOKENS = 50


def layer0(cfg, device, dtype=torch.bfloat16, seed: int = 0):
    """(attention tree, MLP tree, ln_1, ln_2) of the vision tower's layer
    0: the unfolded int8 tree (dynamic scales) and the LN affines in the
    rows' dtype, on ``device``."""
    params = init_clip_params(seed, cfg)
    blocks = params["visual"]["blocks"]
    quant = quantize_clip_params({"visual": params["visual"]})["visual"]
    layer = tree_to(layer_slice(quant, 0), device)
    lns = [tree_to(bk._layer_ln(blocks, 0, name, dtype), device) for name in ("ln_1", "ln_2")]
    return layer["attn"], layer["mlp"], lns[0], lns[1]


def work(crops: int, s: int, e: int, heads: int, hidden: int):
    """(bytes, int8 ops, bf16 ops) of each half: the rows read and written
    once, the int8 weights read once; the GEMMs' and the attention's
    multiply-adds x 2."""
    rows = crops * s
    act = rows * e * 2  # bf16 rows
    attn_bytes = 2 * act + 4 * e * e + 4 * 4 * e  # x in, out; w_qkv + w_out; scales, biases
    mlp_bytes = 2 * act + 2 * e * hidden + 4 * (2 * hidden + 2 * e)
    attn_int8 = 2 * rows * e * (3 * e + e)
    attn_bf16 = 2 * 2 * crops * heads * s * s * (e // heads)  # QK^T and PV
    mlp_int8 = 2 * rows * e * hidden * 2
    return {"attn": (attn_bytes, attn_int8, attn_bf16), "mlp": (mlp_bytes, mlp_int8, 0)}


def bound_ms(n_bytes: int, int8_ops: int, bf16_ops: int):
    """(ms, what bounds it)."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = int8_ops / PEAK_INT8 + bf16_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# the stage functions the halves call, ``block_kernel``'s module globals
STAGES = ("ln_affine_quant_rows", "int8_gemm_bf16", "attention", "quant_rows",
          "int8_gemm_residual", "int8_gemm_f32")


def staged(fn, on_stage) -> None:
    """Runs ``fn()`` with each of ``STAGES`` in ``block_kernel`` replaced by
    ``lambda *a, **k: on_stage(name, lambda: stage(*a, **k))`` (restored
    afterwards)."""
    saved = {name: getattr(bk, name) for name in STAGES}

    def wrap(name, stage):
        return lambda *a, **k: on_stage(name, lambda: stage(*a, **k))

    try:
        for name, stage in saved.items():
            setattr(bk, name, wrap(name, stage))
        fn()
    finally:
        for name, stage in saved.items():
            setattr(bk, name, stage)


def launch_split(fn, device) -> list:
    """[(stage, ms)] of one call of ``fn`` on the card: CUDA events before
    and after each stage."""
    events = []

    def on_stage(name, call):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        events.append((name, start, end))
        return out

    fn()
    staged(fn, on_stage)
    torch.cuda.synchronize(device)
    return [(name, start.elapsed_time(end)) for name, start, end in events]


def run(cfg=VIT_B_32, crops: int = 1024, device="cuda", iters: int = 30, warmup: int = 5,
        seed: int = 0) -> dict:
    device = torch.device(device)
    print(card_line(device), flush=True)
    e, heads = cfg.vision_width, cfg.vision_heads
    attn, mlp, ln1, ln2 = layer0(cfg, device, seed=seed)
    hidden = mlp["c_fc"].w_int8.shape[0]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((crops * TOKENS, e), np.float32))
    x = x.to(device=device, dtype=torch.bfloat16)
    halves = {"attn": lambda: bk.attn_half_int8(x, attn, TOKENS, heads, ln=ln1),
              "mlp": lambda: bk.mlp_half_int8(x, mlp, ln=ln2)}
    res = {"crops": crops, "tokens": TOKENS, "width": e}
    for name, (n_bytes, i8, b16) in work(crops, TOKENS, e, heads, hidden).items():
        ms = time_ms(halves[name], device, iters, warmup)
        bound, by = bound_ms(n_bytes, i8, b16)
        res[name] = {"ms": ms, "bound_ms": bound, "bound_by": by}
        unit = "ms on the card" if device.type == "cuda" else "ms, host clock (CPU)"
        print(f"{name} half int8 (b{crops} x {TOKENS}, E {e}): {ms:.4f} {unit}; H100 bound "
              f"{bound:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, {i8 / 1e9:.1f} G int8 ops, "
              f"{b16 / 1e9:.1f} G bf16 ops)", flush=True)
        if device.type == "cuda":
            split = launch_split(halves[name], device)
            res[name]["stages"] = split
            for stage, k_ms in split:
                print(f"  {k_ms:9.4f} ms  {stage}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crops", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=VIT_B_32.vision_width,
                    help="vision width, heads of 64 (a smaller tower for a CPU run)")
    args = ap.parse_args(argv)
    cfg = VIT_B_32
    if args.width != cfg.vision_width:
        cfg = dataclasses.replace(cfg, vision_width=args.width, vision_layers=1, text_width=64,
                                  text_layers=1, vocab_size=64, embed_dim=32)
    run(cfg, args.crops, args.device, args.iters, warmup=1 if args.device == "cpu" else 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
