"""Training of the port (``jcf_tpu/train``): the stage-1 LoRA step."""

from jcf_tpu_torch.train.lora_stage1 import (
    Stage1State,
    make_stage1_step,
    state_from_numpy,
    state_to_numpy,
)
from jcf_tpu_torch.train.optim import adamw, cosine_annealing_lr

__all__ = ["Stage1State", "adamw", "cosine_annealing_lr", "make_stage1_step",
           "state_from_numpy", "state_to_numpy"]
