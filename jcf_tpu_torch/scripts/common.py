"""What the probe scripts share: the card's name and power limit, its
published peaks, and timing."""

from __future__ import annotations

import subprocess
import time

import torch

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W)
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12


def bound_ms(n_bytes: float, ops: float = 0.0, peak_ops: float = 1.0):
    """The least time the card could take for the work -> (ms, what bounds
    it): the larger of ``n_bytes`` over ``PEAK_BYTES`` and ``ops`` over
    ``peak_ops``, the peak for their type."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def card_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for a CUDA device; for
    the CPU a line that says no card ran."""
    device = torch.device(device)
    if device.type != "cuda":
        return "device: cpu (no card: the times below are host-clock CPU times)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.strip() or f"{torch.cuda.get_device_name(device)}, power limit not read"


def time_ms(fn, device, iters: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after ``warmup``: CUDA
    events on a CUDA device, the host clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - start) / iters * 1e3
    torch.cuda.synchronize(device)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return begin.elapsed_time(end) / iters
