"""Logit post-processing and accuracy metrics (``jcf_tpu/ops/stats.py``).

- ``logit_normalize``: per-row mean subtraction, division by the std over
  all elements (population std, as ``jnp.std``);
- ``top_k_accuracy``: exact top-k match, in percent;
- ``boundary_accuracy``: a top-k entry counts when it lands on the same
  side of the base/new class boundary (373) as the target, in percent of
  the rows (each of the k entries counts).
"""

from __future__ import annotations

import torch


def logit_normalize(logits: torch.Tensor) -> torch.Tensor:
    std = logits.std(unbiased=False)
    mean = logits.mean(dim=1, keepdim=True)
    return (logits - mean) / std


def top_k_accuracy(logits: torch.Tensor, targets: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Percentage of rows whose top-k predictions include the target."""
    pred = torch.topk(logits, k, dim=-1).indices  # [N, k]
    correct = (pred == targets[:, None]).any(dim=-1)
    return 100.0 * correct.float().mean()


def boundary_accuracy(logits: torch.Tensor, targets: torch.Tensor, k: int = 1,
                      boundary: int = 373) -> torch.Tensor:
    """Percentage of top-k predictions on the same side of ``boundary`` as
    the target (every one of the k entries counts, as the reference)."""
    pred = torch.topk(logits, k, dim=-1).indices  # [N, k]
    t = targets[:, None]
    same = ((pred < boundary) & (t < boundary)) | ((pred >= boundary) & (t >= boundary))
    return 100.0 * same.float().sum() / targets.shape[0]
