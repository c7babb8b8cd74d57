"""CoOp-style text prompt tuning (``jcf_tpu/peft/prompt.py``, the
reference's ``VLPromptLearner``).

Four context vectors start as the token embeddings of ``"a photo of a"``;
each class's prompt is ``[SOT embedding, ctx, class-name suffix
embeddings]`` and runs through the text tower's ``encode_text_embeddings``
(the reference's ``TextEncoder``): below 128 tokens without LoRA the fused
causal tower, K6a / K6b in f32 on the default configuration (K9b per
layer under ``_FUSE = "block"``), in the compute dtype.

``ctx`` is the only trainable leaf; the prefix and suffix embeddings and
the token ids are frozen buffers computed once by ``init_prompt_learner``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, NamedTuple, Optional

import numpy as np
import torch

from jcf_tpu_torch.tokenizer import tokenize

if TYPE_CHECKING:  # models.clip imports ops.attention, which imports this package
    from jcf_tpu_torch.models.clip import CLIPConfig


class PromptLearner(NamedTuple):
    ctx: torch.Tensor  # [n_ctx, text_width], trainable
    token_prefix: torch.Tensor  # [C, 1, text_width]: the SOT embedding
    token_suffix: torch.Tensor  # [C, 77 - 1 - n_ctx, text_width]
    tokenized: torch.Tensor  # [C, 77] int32 prompt token ids


def init_prompt_learner(clip_params: dict, cfg: "CLIPConfig", classnames: List[str],
                        ctx_init: str = "a photo of a", n_ctx: int = 4) -> PromptLearner:
    """The learner of ``classnames`` (underscores read as spaces), each
    prompt ``f"{ctx_init} {name}."`` tokenized with truncation to the
    context length (EOT kept last); CPU tensors from the text tower's f32
    token table."""
    table = clip_params["text"]["token_embedding"].detach().float().cpu().numpy()
    init_ids = tokenize(ctx_init)[0]
    ctx = table[init_ids[1 : 1 + n_ctx]]
    prompts = [f"{ctx_init} {name.replace('_', ' ')}." for name in classnames]
    tokenized = tokenize(prompts, truncate=True)  # [C, 77]
    embedding = table[tokenized]  # [C, 77, tw]
    return PromptLearner(
        ctx=torch.from_numpy(np.ascontiguousarray(ctx)),
        token_prefix=torch.from_numpy(np.ascontiguousarray(embedding[:, :1, :])),
        token_suffix=torch.from_numpy(np.ascontiguousarray(embedding[:, 1 + n_ctx :, :])),
        tokenized=torch.from_numpy(tokenized),
    )


def build_prompt_embeddings(learner: PromptLearner,
                            ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[C, 77, tw] prompt embeddings with ``ctx`` (the learner's own where
    None) spliced in after SOT, on ``ctx``'s device."""
    ctx = learner.ctx if ctx is None else ctx
    c = learner.token_prefix.shape[0]
    dev = ctx.device
    return torch.cat([learner.token_prefix.to(dev), ctx[None].expand(c, *ctx.shape),
                      learner.token_suffix.to(dev)], dim=1)


def prompt_text_features(clip_params: dict, cfg: "CLIPConfig", learner: PromptLearner,
                         ctx: Optional[torch.Tensor] = None, *,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Prompt-tuned class text features [C, embed_dim] (not normalized) in
    ``dtype``, computed where ``ctx`` and the text params lie (the
    learner's buffers follow ``ctx``). In f32 the text weights are split
    into their TF32 planes first (kept where ``clip_params`` has them)."""
    from jcf_tpu_torch.models.clip import encode_text_embeddings
    from jcf_tpu_torch.ops.f32_gemm import with_tf32_planes

    if dtype == torch.float32:
        text = clip_params["text"]
        clip_params = {**clip_params, "text": {**text, "blocks": with_tf32_planes(text["blocks"])}}
    emb = build_prompt_embeddings(learner, ctx)
    eot = learner.tokenized.to(emb.device).long().argmax(dim=-1)
    return encode_text_embeddings(clip_params, cfg, emb, eot, dtype=dtype)
