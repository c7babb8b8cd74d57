"""Pipeline plumbing of the port (``jcf_tpu/pipelines``)."""

from jcf_tpu_torch.pipelines.common import build_text_weights, ensure_templates
from jcf_tpu_torch.pipelines.train_lora import lora_spec_from_config, tokenize_banks

__all__ = ["build_text_weights", "ensure_templates", "lora_spec_from_config", "tokenize_banks"]
