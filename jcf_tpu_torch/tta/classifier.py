"""Zero-shot classifier from class templates (``jcf_tpu/tta/classifier.py``).

For each class: encode every template sentence, L2-normalize each
embedding, average over the templates, normalize again; stack into [C, D]
weights. All C * T prompts are tokenized once and encoded in batches of
512 through the text tower (``models.clip.encode_text``, the K6a/K6b
kernels on the card), in f32 (the default, as the JAX package's, and the
reference preset's compute dtype) or bf16 (the perf preset's); with
``quant`` (``ops.quant.quantize_clip_params(params)["text"]``) the int8
text tower (K3/K4 with the masked attention), a memory and latency
option certified against the f32 classifier (rows cos > 0.99, as
``tests/test_quant.py`` certifies the JAX package's).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from jcf_tpu_torch.models.clip import CLIPConfig, encode_text, tree_to
from jcf_tpu_torch.ops.f32_gemm import with_tf32_planes
from jcf_tpu_torch.ops.layers import l2_normalize
from jcf_tpu_torch.tokenizer import tokenize


def _mean(emb: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean``: accumulated in f32, cast back to the input dtype."""
    return emb.float().mean(dim=dim).to(emb.dtype)


def _encode_normalized(params: dict, cfg: CLIPConfig, ids, batch_size: int, device,
                       dtype: torch.dtype, quant) -> torch.Tensor:
    """L2-normalized text features of token ids [N, ctx], ``batch_size``
    prompts per tower call -> [N, D] in ``dtype`` on ``device``. The f32
    tower's weights are split into their TF32 planes once, before the
    batches."""
    text = tree_to(params["text"], device)
    if quant is not None:
        quant = tree_to(quant, device)
    elif dtype == torch.float32:
        text = {**text, "blocks": with_tf32_planes(text["blocks"])}
    params = {"text": text}
    ids = torch.as_tensor(ids)
    return torch.cat([l2_normalize(encode_text(params, cfg, ids[i : i + batch_size], device=device,
                                               dtype=dtype, quant=quant))
                      for i in range(0, ids.shape[0], batch_size)])


def encode_class_templates(params: dict, cfg: CLIPConfig, token_ids, *, batch_size: int = 512,
                           device="cuda", dtype: torch.dtype = torch.float32,
                           quant: dict | None = None) -> torch.Tensor:
    """Template token ids [C, T, ctx] -> classifier weights [C, D] in
    ``dtype``; int8 text tower with ``quant``."""
    c, t, ctx = token_ids.shape
    emb = _encode_normalized(params, cfg, token_ids.reshape(c * t, ctx), batch_size, device, dtype,
                             quant)
    return l2_normalize(_mean(emb.reshape(c, t, -1), 1))


def build_classifier_weights(params: dict, cfg: CLIPConfig,
                             templates: Dict[int, List[str]] | Sequence[List[str]], *,
                             batch_size: int = 512, device="cuda",
                             dtype: torch.dtype = torch.float32,
                             quant: dict | None = None) -> torch.Tensor:
    """Classifier weights [C, D] in ``dtype`` from {class_id: [template
    strings]} (classes in key order) or a list of template lists. Classes
    with different template counts average their own templates exactly.
    ``quant``: the int8 text tree, as ``encode_class_templates``."""
    if isinstance(templates, dict):
        items = [templates[k] for k in sorted(templates.keys())]
    else:
        items = list(templates)
    if len({len(v) for v in items}) == 1:
        ids = np.stack([tokenize(v, context_length=cfg.context_length, truncate=True)
                        for v in items])  # [C, T, ctx]
        return encode_class_templates(params, cfg, ids, batch_size=batch_size, device=device,
                                      dtype=dtype, quant=quant)
    flat = [s for v in items for s in v]
    ids = tokenize(flat, context_length=cfg.context_length, truncate=True)
    emb = _encode_normalized(params, cfg, ids, batch_size, device, dtype, quant)
    weights, offset = [], 0
    for v in items:
        weights.append(l2_normalize(_mean(emb[offset : offset + len(v)], 0)))
        offset += len(v)
    return torch.stack(weights)
