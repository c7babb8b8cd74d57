"""Global seeding (``jcf_tpu/utils/seeding.py``): Python's and numpy's
generators, as the JAX package seeds them, and torch's."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
