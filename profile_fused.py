#!/usr/bin/env python3
"""Where the fused int8 layer K9d (``layer_fused_int8``, a block a crop)
spends its time, on one NVIDIA GPU.

    python3 profile_fused.py            # from the repository root

Builds ``jcf_tpu_torch/csrc`` with ``-DJCF_FUSED_PROFILE`` (its own build
directory: the flags are part of the build hash), then runs
``layer_fused_int8`` on one ViT-B/32 layer (seed-0 weights, fixed
activation scales) at b1024 x 8 views = 8192 crops of 50 rows. Prints the
time per launch (CUDA events; the profile build's extra barriers are in
it) and the share of each phase of the kernel in the cycles that thread 0
of every block spends in it: LN1, the qkv GEMMs, the attention, the
out-projection, LN2, c_fc with its GELU-quant epilogue, c_proj. (K9a's
dense branches and K9c run the persistent kernel of
``csrc/block_int8.cu``, which has no profile build.)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("LN1", "qkv GEMMs", "attention", "out-proj", "LN2", "c_fc + GELU", "c_proj")
CROPS, REPS = 8192, 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_fused: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from jcf_tpu_torch import _build
    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    _build.NVCC_FLAGS.append("-DJCF_FUSED_PROFILE")
    _build.SIGNATURES["jcf_fused_profile"] = [ctypes.c_void_p]
    lib = _build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    params = init_clip_params(0, CLIPConfig(vision_layers=1))
    amax = torch.tensor([[6.0, 6.0, 3.0, 4.0]])
    tree = quantize_clip_params(params, fold=True, heads={"visual": 12}, act_scales={"visual": amax})["visual"]
    layer = {half: {k: (type(v)(*(t.to(dev) for t in v)) if isinstance(v, tuple) else v.to(dev))
                    for k, v in d.items()} for half, d in layer_slice(tree, 0).items()}
    x = torch.randn(CROPS * 50, 768, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0)).bfloat16()
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    print(f"card: {smi}")
    for name in ("layer_fused_int8",):
        fn = getattr(bk, name)
        fn(x, layer, 50, 12)
        torch.cuda.synchronize()
        _build.check(lib.jcf_fused_profile(ctypes.addressof(cycles)), "jcf_fused_profile")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn(x, layer, 50, 12)
        end.record()
        torch.cuda.synchronize()
        _build.check(lib.jcf_fused_profile(ctypes.addressof(cycles)), "jcf_fused_profile")
        total = sum(cycles)
        shares = ", ".join(f"{p} {c / total:.3f}" for p, c in zip(PHASES, cycles))
        print(f"{name}: {start.elapsed_time(end) / REPS:.3f} ms per launch at {CROPS} crops; "
              f"{total / REPS / CROPS:.0f} cycles per crop; shares: {shares}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
