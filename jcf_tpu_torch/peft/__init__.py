"""Parameter-efficient fine-tuning of the port (``jcf_tpu/peft``): LoRA."""

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

__all__ = [
    "INDEX_POSITIONS_TEXT",
    "INDEX_POSITIONS_VISION",
    "LoraSpec",
    "init_lora_params",
    "lora_layer_masks",
    "load_lora",
    "load_lora_swa",
    "make_lora_context",
    "merge_lora_params",
    "save_lora",
]
