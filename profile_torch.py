#!/usr/bin/env python3
"""Device-time profile of the PyTorch/CUDA port's serving slice on one GPU.

    python3 profile_torch.py            # from the repository root

Builds the int8 ``TTAEngine`` as ``chip_smoke.py`` does (ViT-B/32, seed-0
weights and images, b1024 x 8 views, the crop geometry sampled on the card
each iteration), times ``ITERS`` iterations without the profiler, then
records ``PROFILED`` iterations under ``torch.profiler``. For each device
kernel (and memcpy / memset) it prints launches and device ms per
iteration and its share of the profiled wall time. The busy share is the
summed device time over that wall time: the port launches on one stream,
so device activities do not overlap. The idle share is its complement.

The table (JSON) and a Chrome trace are written to ``chiprun_out/`` beside
this script. Exits nonzero when no CUDA device is present or the profiler
records no device time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024  # images per serving batch, as bench.py
VIEWS = 8  # views per image, the center view included
ITERS = 10  # unprofiled iterations
PROFILED = 3  # iterations under the profiler


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import VIT_B_32, init_clip_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    cfg = VIT_B_32
    rng = np.random.default_rng(0)
    images_np = rng.random((BATCH, 3, 256, 256)).astype(np.float32)
    text = rng.standard_normal((403, cfg.embed_dim)).astype(np.float32)
    text = torch.from_numpy(text / np.linalg.norm(text, axis=-1, keepdims=True)).to(dev)
    images = torch.from_numpy(images_np).to(dev, torch.bfloat16)
    engine = TTAEngine(init_clip_params(0, cfg), cfg, device=dev, n_views=VIEWS - 1,
                       calibration_images=images_np)
    gen = torch.Generator(device=dev).manual_seed(2)

    def step():
        return engine.features_from_images(images, text, generator=gen)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(n):
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            step()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for _ in range(2):
        step()
    plain_ms = timed(ITERS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed(PROFILED)

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        rows.append({"kernel": evt.key, "launches_per_iter": evt.count / PROFILED,
                     "ms_per_iter": evt.self_device_time_total / 1e3 / PROFILED})
    if not rows:
        print("profile_torch: the profiler recorded no device time", file=sys.stderr)
        return 1
    rows.sort(key=lambda r: -r["ms_per_iter"])
    for r in rows:
        r["share"] = r["ms_per_iter"] / profiled_ms
    busy_ms = sum(r["ms_per_iter"] for r in rows)

    print(f"b{BATCH} x {VIEWS} views: unprofiled {plain_ms:.3f} ms/iter "
          f"({BATCH * 1e3 / plain_ms:.2f} img/s), profiled {profiled_ms:.3f} ms/iter")
    print(f"device busy {busy_ms:.3f} ms/iter = {busy_ms / profiled_ms:.4f} of the profiled "
          f"wall time (idle share {1 - busy_ms / profiled_ms:.4f})")
    print(f"{'ms/iter':>10} {'share':>7} {'launches':>9}  kernel")
    for r in rows:
        print(f"{r['ms_per_iter']:10.3f} {r['share']:7.4f} {r['launches_per_iter']:9.1f}  "
              f"{r['kernel'][:100]}")

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_torch.json"), "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "batch": BATCH, "views": VIEWS, "unprofiled_ms_per_iter": plain_ms,
                   "profiled_ms_per_iter": profiled_ms, "busy_ms_per_iter": busy_ms,
                   "kernels": rows, "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())},
                  f, indent=1)
    prof.export_chrome_trace(os.path.join(out_dir, "profile_torch_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
