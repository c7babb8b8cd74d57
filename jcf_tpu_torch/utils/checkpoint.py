"""Tree checkpoints (``jcf_tpu/utils/checkpoint.py``): a pickle of the
tree with every tensor as a numpy array, structure kept (dicts, lists,
tuples), so a run can resume where it stopped. Unpickle only files this
program wrote."""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def save_pytree(tree: Any, path: str) -> None:
    """Pickle ``tree`` with its tensors as numpy arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _map(tree, lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)
    with open(path, "wb") as f:
        pickle.dump(arrays, f)


def load_pytree(path: str) -> Any:
    """The tree ``save_pytree`` wrote, its numpy arrays as CPU tensors."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return _map(tree, lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
