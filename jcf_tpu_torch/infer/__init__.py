"""Inference engine of the port (``jcf_tpu/infer``)."""

from jcf_tpu_torch.infer.engine import TTAEngine

__all__ = ["TTAEngine"]
