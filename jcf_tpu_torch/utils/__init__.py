"""Utilities of the port (``jcf_tpu/utils``): tree checkpoints, the
logger, the phase timer and seeding."""

from jcf_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from jcf_tpu_torch.utils.logging import get_logger
from jcf_tpu_torch.utils.profiling import Timer
from jcf_tpu_torch.utils.seeding import set_random_seed

__all__ = ["Timer", "get_logger", "load_pytree", "save_pytree", "set_random_seed"]
