"""Multi-head self-attention (``jcf_tpu/ops/attention.py``), plain part.

Only the composable path the calibration forward and the f32 reference
tower use. The Pallas kernels of the JAX module (``_packed_attn_kernel``,
``_attn_kernel_blocked``) are not on the serving slice and are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from jcf_tpu_torch.ops.layers import linear


def attention(q, k, v, bias=None):
    """Softmax attention over [B, H, S, D] tensors (``_attention_xla``):
    f32 scores scaled by 1/sqrt(D), optional additive bias, probabilities
    cast to q.dtype before PV, output in q.dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def multi_head_attention(x: torch.Tensor, params: dict, n_heads: int,
                         mask: torch.Tensor | None = None, *,
                         return_pre_proj: bool = False) -> torch.Tensor:
    """Self-attention over batch-first [B, S, E] with the packed CLIP
    in-projection ``w_qkv [3E, E]`` / ``b_qkv [3E]``."""
    b, s, e = x.shape
    d = e // n_heads
    qkv = linear(x, params["w_qkv"], params["b_qkv"]).reshape(b, s, 3, n_heads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, S, D]
    out = attention(q, k, v, mask).transpose(1, 2).reshape(b, s, e)
    if return_pre_proj:
        return out
    return linear(out, params["w_out"], params["b_out"])
