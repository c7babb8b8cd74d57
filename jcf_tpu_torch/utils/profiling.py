"""Wall-clock phase timer (``jcf_tpu/utils/profiling.py``'s ``Timer``)."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


def _synchronize(tensors) -> None:
    """Waits for the CUDA devices that hold any of ``tensors`` (a tensor
    or a nested list / tuple / dict of them)."""
    devices = set()

    def visit(t):
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                devices.add(t.device)
        elif isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                visit(v)

    visit(tensors)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating phase timer. ``block_on`` (tensors) makes a phase wait
    for their devices before it stops the clock, so that asynchronous CUDA
    work is counted in the phase that launched it."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            name: {"total_s": t, "count": self.counts[name], "mean_s": t / self.counts[name]}
            for name, t in self.totals.items()
        }
