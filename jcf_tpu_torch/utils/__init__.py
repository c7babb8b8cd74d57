"""Utilities of the port (``jcf_tpu/utils``): tree checkpoints."""

from jcf_tpu_torch.utils.checkpoint import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
