"""Int8 W8A8 weight quantization (``jcf_tpu/ops/quant.py``) in PyTorch.

Weights: static per-output-channel symmetric int8 from |W|max. The one
ported route is the serving one (``fold=True``, static mode "full" in
the JAX package): the LayerNorm affine folds into the following
projection and 1/sqrt(d) into the q third of ``w_qkv``, and the calibrated
post-LN, attention-context and post-GELU activation quantizations become
static per-layer scales folded into the weight dequant scales. Same
formulas, margins and op order as the JAX package, so the int8 weights
are equal and the f32 scales agree to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# margins on the calibrated amax: the z-scored LN inputs, and the static
# ctx / hidden scales, whose per-row amax varies more
LN_MARGIN = 1.05
STATIC_MARGIN = 1.10


class QuantizedLinear(NamedTuple):
    w_int8: torch.Tensor  # [..., out, in] int8
    w_scale: torch.Tensor  # [..., out] f32 per-output-channel
    bias: torch.Tensor | None  # [..., out] f32


def quantize_weight(weight: torch.Tensor, bias: torch.Tensor | None = None) -> QuantizedLinear:
    """[..., out, in] float weight -> per-channel symmetric int8."""
    w = weight.float()
    scale = torch.clamp_min(w.abs().amax(dim=-1) / 127.0, 1e-8)
    w_int8 = torch.clamp(torch.round(w / scale[..., None]), -127, 127).to(torch.int8)
    return QuantizedLinear(w_int8, scale, bias)


def quantize_clip_params(params: dict, *, heads: dict, act_scales: dict) -> dict:
    """Quantize the vision tower's block matmuls -> ``{"visual": tree}``.

    ``act_scales={"visual": amax [L, 4]}`` is the calibrated amax of the
    LN-1, LN-2, attention-context and post-GELU activations per layer
    (``models.clip.vision_ln_z_amax``). The other quantization modes of the
    JAX package are not ported (ROADMAP.md).
    """
    act = act_scales["visual"]
    blocks = params["visual"]["blocks"]
    n_heads = heads["visual"]

    w_qkv = blocks["attn"]["w_qkv"].float()  # [L, 3E, E]
    b_qkv = blocks["attn"]["b_qkv"].float()
    w_fc = blocks["mlp"]["c_fc"]["w"].float()
    b_fc = blocks["mlp"]["c_fc"]["b"].float()
    e = w_qkv.shape[-1]
    g1 = blocks["ln_1"]["scale"].float()
    be1 = blocks["ln_1"]["bias"].float()
    g2 = blocks["ln_2"]["scale"].float()
    be2 = blocks["ln_2"]["bias"].float()
    b_qkv = b_qkv + torch.einsum("loe,le->lo", w_qkv, be1)
    w_qkv = w_qkv * g1[:, None, :]
    b_fc = b_fc + torch.einsum("loe,le->lo", w_fc, be2)
    w_fc = w_fc * g2[:, None, :]
    # 1/sqrt(d) into the q third (weights and bias)
    s = 1.0 / torch.sqrt(torch.tensor(float(e // n_heads), dtype=torch.float32))
    q_rows = torch.arange(w_qkv.shape[1], device=w_qkv.device) < e
    w_qkv = torch.where(q_rows[None, :, None], w_qkv * s, w_qkv)
    b_qkv = torch.where(q_rows[None, :], b_qkv * s, b_qkv)
    qkv_q = quantize_weight(w_qkv, b_qkv)
    fc_q = quantize_weight(w_fc, b_fc)
    w_out = quantize_weight(blocks["attn"]["w_out"], blocks["attn"]["b_out"].float())
    c_proj = quantize_weight(blocks["mlp"]["c_proj"]["w"], blocks["mlp"]["c_proj"]["b"].float())

    a = torch.as_tensor(act, dtype=torch.float32, device=w_qkv.device) * LN_MARGIN
    ah = a[:, 2:4] * (STATIC_MARGIN / LN_MARGIN)  # the reference's op order
    tree = {
        "attn": {
            "w_qkv": qkv_q._replace(w_scale=qkv_q.w_scale * (a[:, 0] / 127.0)[:, None]),
            "w_out": w_out._replace(w_scale=w_out.w_scale * (ah[:, 0] / 127.0)[:, None]),
            "ln_inv": (127.0 / a[:, 0]).reshape(-1, 1, 1),
            "ctx_inv": (127.0 / ah[:, 0]).reshape(-1, 1, 1),
        },
        "mlp": {
            "c_fc": fc_q._replace(w_scale=fc_q.w_scale * (a[:, 1] / 127.0)[:, None]),
            "c_proj": c_proj._replace(w_scale=c_proj.w_scale * (ah[:, 1] / 127.0)[:, None]),
            "ln_inv": (127.0 / a[:, 1]).reshape(-1, 1, 1),
            "h_inv": (127.0 / ah[:, 1]).reshape(-1, 1, 1),
        },
    }
    return {"visual": tree}
