"""Optimizer and schedule (``jcf_tpu/train/optim.py``).

- AdamW(lr 2e-4, betas (0.9, 0.999), wd 1e-2, eps 1e-8): ``torch.optim.AdamW``
  makes the same update as ``optax.adamw``,
  p - lr (m_hat / (sqrt(v_hat) + eps) + wd p), with decay on every leaf.
- CosineAnnealingLR in closed form, eta_min + (lr - eta_min)(1 + cos(pi t/T))/2,
  not clamped past T (periodic, as torch and jittor).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import torch


def cosine_annealing_lr(base_lr: float, t_max: int, eta_min: float = 0.0) -> Callable:
    def schedule(step):
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * step / t_max)) / 2

    return schedule


def adamw(lr: float = 2e-4, betas: Tuple[float, float] = (0.9, 0.999),
          weight_decay: float = 1e-2, eps: float = 1e-8) -> Callable:
    """-> a function of the parameter list that returns
    ``torch.optim.AdamW`` over them with these settings."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=betas, eps=eps,
                             weight_decay=weight_decay)
