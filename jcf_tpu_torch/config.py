"""The part of ``jcf_tpu/config.py`` the classifier build and stage-1
LoRA training read.

Defaults are the JAX package's (tests/test_torch_tokenizer.py compares
them field by field); ``perf_preset`` is its throughput configuration as
far as these fields go (bf16 compute).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    classes_file: str = "Dataset/classes.txt"
    template_dir: str = "text_template"
    captions_file: str = "class_caption.txt"


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 4
    alpha: float = 1.0
    dropout_rate: float = 0.25
    params: Tuple[str, ...] = ("q", "k", "v")
    encoder: str = "both"
    position: str = "all"
    backbone: str = "ViT-B/32"


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    epochs: int = 50  # lora_train_vlp.py:940
    batch_size: int = 256
    lr: float = 2e-4
    weight_decay: float = 1e-2
    betas: Tuple[float, float] = (0.9, 0.999)
    logit_scale: float = 100.0
    eval_from_epoch: int = 20  # lora_train_vlp.py:1013
    seed: int = 1
    crop_scale: Tuple[float, float] = (0.05, 1.0)  # train RandomResizedCrop
    save_path: str = "lora_weights1/lora_weights.pkl"
    # folder of LoRA pkls to average (SWA) instead of loading save_path
    swa_dir: str = ""
    resume: bool = True
    checkpoint_path: str = "checkpoints/stage1_state.pkl"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    compute_dtype: str = "float32"  # "bfloat16" for the perf path
    # directory of the content-keyed text-classifier cache; None disables
    classifier_cache: Optional[str] = ".jcf_cache"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    lora: LoraConfig = dataclasses.field(default_factory=LoraConfig)
    stage1: Stage1Config = dataclasses.field(default_factory=Stage1Config)


def perf_preset() -> PipelineConfig:
    """The throughput configuration's fields here: bf16 compute."""
    base = PipelineConfig()
    return dataclasses.replace(
        base, runtime=dataclasses.replace(base.runtime, compute_dtype="bfloat16"))
