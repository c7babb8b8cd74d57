"""The part of ``jcf_tpu/config.py`` the classifier build reads.

Defaults are the JAX package's (tests/test_torch_tokenizer.py compares
them field by field); ``perf_preset`` is its throughput configuration as
far as these fields go (bf16 compute).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DataConfig:
    classes_file: str = "Dataset/classes.txt"
    template_dir: str = "text_template"
    captions_file: str = "class_caption.txt"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    compute_dtype: str = "float32"  # "bfloat16" for the perf path
    # directory of the content-keyed text-classifier cache; None disables
    classifier_cache: Optional[str] = ".jcf_cache"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)


def perf_preset() -> PipelineConfig:
    """The throughput configuration's fields here: bf16 compute."""
    base = PipelineConfig()
    return dataclasses.replace(
        base, runtime=dataclasses.replace(base.runtime, compute_dtype="bfloat16"))
