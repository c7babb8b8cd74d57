"""Pipeline plumbing of the port (``jcf_tpu/pipelines``)."""

from jcf_tpu_torch.pipelines.common import build_text_weights, ensure_templates

__all__ = ["build_text_weights", "ensure_templates"]
