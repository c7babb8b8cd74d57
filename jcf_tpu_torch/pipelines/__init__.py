"""Pipeline plumbing of the port (``jcf_tpu/pipelines``)."""

from jcf_tpu_torch.pipelines.common import (
    build_engine,
    build_text_weights,
    ensure_templates,
    load_model_for_pipeline,
    serving_mesh,
    stack_center_and_crops,
    tta_loader,
)
from jcf_tpu_torch.pipelines.ood import run_ood_split
from jcf_tpu_torch.pipelines.predict import run_predict
from jcf_tpu_torch.pipelines.train_lora import lora_spec_from_config, tokenize_banks

__all__ = ["build_engine", "build_text_weights", "ensure_templates", "load_model_for_pipeline",
           "lora_spec_from_config", "run_ood_split", "run_predict", "serving_mesh",
           "stack_center_and_crops", "tokenize_banks", "tta_loader"]
