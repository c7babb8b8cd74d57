"""The part of ``jcf_tpu/config.py`` the classifier build, the TTA
engines, stage-1 LoRA training, ``jcf-ood``, ``jcf-predict`` and their
CLIs read.

Defaults are the JAX package's (tests/test_torch_tokenizer.py and
tests/test_torch_float_tower.py compare them field by field);
``perf_preset`` is its throughput configuration (8 device-sampled views,
bf16, static int8) and ``reference_preset`` its exact reference
configuration (512 + 1 crops, f32, no quantization), as far as these
fields go. Fields the JAX package orders otherwise come last here, so
that positional construction of the older fields keeps working.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    classes_file: str = "Dataset/classes.txt"
    template_dir: str = "text_template"
    captions_file: str = "class_caption.txt"
    root: str = "Dataset"
    test_dir: str = "Dataset/TestSetB"
    num_classes: int = 403
    num_workers: int = 8
    train_split: str = "Dataset/train.txt"
    val_split: str = "Dataset/valid1.txt"
    shots: int = 4


@dataclasses.dataclass(frozen=True)
class TTAConfig:
    n_views: int = 512  # reference crop count (ood.py:956); perf preset uses 8
    crop_scale: Tuple[float, float] = (0.5, 1.0)
    view_size: int = 224
    resize_to: int = 256
    device_crops: bool = False  # True = sample views on the device (throughput path)
    # images per device batch; per-image results are independent
    batch_images: int = 8


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
class Stage2Config:
    """Stage 2 (the joint prompt / head training) and the artifacts
    ``jcf-predict`` reads from it: ``out_dir`` (``clip_model.pkl`` with its
    visual prompts, ``lora_weights.pkl``, ``channel.pkl``,
    ``moco_adapter.pkl``, ``PromptLearner.pkl``), the MoCo checkpoint, and
    the prompt learner's ``n_ctx`` and ``ctx_init``. The training fields
    are kept as plain fields with the JAX defaults (stage 2 is not ported)."""
    epochs: int = 20  # slow_pace.py:1577
    batch_size: int = 128
    lr: float = 2e-4
    weight_decay: float = 1e-2
    betas: Tuple[float, float] = (0.9, 0.999)
    cosine_eta_min: float = 1e-6
    # the reference steps its CosineAnnealingLR(T_max=20) every batch
    scheduler_step_per_batch: bool = True
    logit_scale: float = 100.0
    seed: int = 346373
    n_ctx: int = 4
    ctx_init: str = "a photo of a"
    full_ensemble_val: bool = True
    moco_checkpoint: str = "r-50-1000ep.pkl"
    resume: bool = True
    checkpoint_path: str = "checkpoints/stage2_state.pkl"
    out_dir: str = "test_pkl"
    feature_cache_1: str = "features_zs1.pkl"
    feature_cache_2: str = "features_zs2.pkl"
    label_cache_2: str = "label_zs2.pkl"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    compute_dtype: str = "float32"  # "bfloat16" for the perf path
    # directory of the content-keyed text-classifier cache; None disables
    classifier_cache: Optional[str] = ".jcf_cache"
    quant: Optional[str] = None  # "int8" = W8A8 serving towers (certified)
    # calibrate static activation scales on the first decoded batch (int8)
    static_quant: bool = False
    # which quantizations go static: "ln", "hidden", "full", optionally "+score"
    static_quant_mode: str = "full"
    clip_checkpoint: str = "ViT-B-32.pkl"
    # accepted for the JAX CLI's flag; the port has one attention route on
    # the card, so any value but None is refused where an engine is built
    attention_impl: Optional[str] = None
    # shard serving batches over the visible devices; the port serves on
    # one GPU (pipelines.common.serving_mesh returns None)
    data_parallel: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    lora: LoraConfig = dataclasses.field(default_factory=LoraConfig)
    stage1: Stage1Config = dataclasses.field(default_factory=Stage1Config)
    tta: TTAConfig = dataclasses.field(default_factory=TTAConfig)
    stage2: Stage2Config = dataclasses.field(default_factory=Stage2Config)


def perf_preset() -> PipelineConfig:
    """The throughput configuration: 8 device-sampled views, bf16, int8
    towers with static activation scales."""
    base = PipelineConfig()
    return dataclasses.replace(
        base,
        tta=dataclasses.replace(base.tta, n_views=8, device_crops=True, batch_images=128),
        runtime=dataclasses.replace(base.runtime, compute_dtype="bfloat16", quant="int8",
                                    static_quant=True),
    )


def reference_preset() -> PipelineConfig:
    """Exact reference behavior (512 + 1 host crops, f32, no quantization)."""
    return PipelineConfig()
