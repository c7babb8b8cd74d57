"""Pipeline plumbing of the port (``jcf_tpu/pipelines``)."""

from jcf_tpu_torch.pipelines.common import (
    build_engine,
    build_text_weights,
    ensure_templates,
    load_model_for_pipeline,
    stack_center_and_crops,
)
from jcf_tpu_torch.pipelines.train_lora import lora_spec_from_config, tokenize_banks

__all__ = ["build_engine", "build_text_weights", "ensure_templates", "load_model_for_pipeline",
           "lora_spec_from_config", "stack_center_and_crops", "tokenize_banks"]
