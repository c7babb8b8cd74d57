"""Parameter-efficient fine-tuning of the port (``jcf_tpu/peft``): LoRA and
the text prompt learner."""

from jcf_tpu_torch.peft.lora import (
    INDEX_POSITIONS_TEXT,
    INDEX_POSITIONS_VISION,
    LoraSpec,
    init_lora_params,
    lora_layer_masks,
    make_lora_context,
    merge_lora_params,
)
from jcf_tpu_torch.peft.lora_io import load_lora, load_lora_swa, save_lora
from jcf_tpu_torch.peft.prompt import (
    PromptLearner,
    build_prompt_embeddings,
    init_prompt_learner,
    prompt_text_features,
)

__all__ = [
    "INDEX_POSITIONS_TEXT",
    "INDEX_POSITIONS_VISION",
    "LoraSpec",
    "PromptLearner",
    "build_prompt_embeddings",
    "init_lora_params",
    "init_prompt_learner",
    "lora_layer_masks",
    "load_lora",
    "load_lora_swa",
    "make_lora_context",
    "merge_lora_params",
    "prompt_text_features",
    "save_lora",
]
