"""Threaded prefetching data loader (``jcf_tpu/data/loader.py``): a
thread pool decodes one batch's samples in parallel, a bounded queue
keeps a few batches ahead, and batches come out in dataset order
(randomness lives in the per-sample seeded transforms, not in the
scheduling)."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

_PREFETCH = 4  # batches decoded ahead of the consumer


def _stack_batch(samples: Sequence):
    """Collate: tensors and numpy arrays stack (as tensors); ints become an
    int32 tensor, floats an f32 one; strings stay lists."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(_stack_batch([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(samples)
    if isinstance(first, np.ndarray):
        return torch.from_numpy(np.stack(samples))
    if isinstance(first, (int, np.integer)):
        return torch.tensor(np.asarray(samples, np.int32))
    if isinstance(first, float):
        return torch.tensor(np.asarray(samples, np.float32))
    return list(samples)


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        batches = [range(i, min(i + self.batch_size, n)) for i in range(0, n, self.batch_size)]
        out_q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        sentinel = object()
        stop = threading.Event()
        failure = []

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            break
                        out_q.put(_stack_batch(list(pool.map(self.dataset.__getitem__, idxs))))
            except BaseException as exc:  # handed to the consumer, which raises it
                failure.append(exc)
            finally:
                out_q.put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # drain so that a blocked put returns
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
        if failure:
            raise failure[0]
