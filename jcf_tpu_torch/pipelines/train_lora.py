"""Stage-1 LoRA training pipeline (``jcf_tpu/pipelines/train_lora.py``),
its device-free part: the template banks as token ids and the LoRA spec
from the configuration. The epoch loop (``run_train_lora``) waits for the
port's image decode and augmentation."""

from __future__ import annotations

import numpy as np
import torch

from jcf_tpu_torch.config import PipelineConfig
from jcf_tpu_torch.data.templates import load_template_file
from jcf_tpu_torch.peft.lora import LoraSpec
from jcf_tpu_torch.tokenizer import tokenize


def tokenize_banks(cfg: PipelineConfig, n_banks: int = 8) -> torch.Tensor:
    """[n_banks, C, 77] int32 token ids for every template bank."""
    banks = []
    for idx in range(1, n_banks + 1):
        bank = load_template_file(cfg.data.template_dir, idx)
        texts = [bank[i][0] for i in sorted(bank.keys())]
        banks.append(tokenize(texts, truncate=True))
    return torch.from_numpy(np.stack(banks))


def lora_spec_from_config(cfg: PipelineConfig) -> LoraSpec:
    lc = cfg.lora
    return LoraSpec(r=lc.r, alpha=lc.alpha, dropout_rate=lc.dropout_rate, params=tuple(lc.params),
                    encoder=lc.encoder, position=lc.position, backbone=lc.backbone)
