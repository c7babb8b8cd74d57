"""Data helpers of the port (``jcf_tpu/data``): the class templates."""

from jcf_tpu_torch.data.templates import (
    TEMPLATE_PATTERNS,
    load_class_templates,
    load_template_file,
    synthesize_templates,
)

__all__ = ["TEMPLATE_PATTERNS", "load_class_templates", "load_template_file",
           "synthesize_templates"]
