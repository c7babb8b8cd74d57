"""Test-time augmentation of the port (``jcf_tpu/tta``)."""

from jcf_tpu_torch.tta.mta import MTAParams, solve_mta, solve_mta_batch

__all__ = ["MTAParams", "solve_mta", "solve_mta_batch"]
