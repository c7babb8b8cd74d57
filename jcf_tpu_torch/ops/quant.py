"""Int8 W8A8 quantization (``jcf_tpu/ops/quant.py``) in PyTorch.

Weights: static per-output-channel symmetric int8 from |W|max. Two trees
per tower (the vision and the text tower):

- unfolded (``fold=False``, the default, as in the JAX package): each
  projection's weight and bias as they are. The fused tower below 128
  tokens runs it with the LN affine and the 1/sqrt(d) score scale in its
  kernels and every activation scale dynamic per row (the int8 text
  tower and its classifier build, the unfolded vision tower); the
  composable tower (from 128 tokens on, or under a LoRA context) with
  ``int8_linear``, which quantizes its input rows dynamically;
- folded (``fold=True``), the serving engine's below 128 tokens: the
  LayerNorm affine folds into the following projection and 1/sqrt(d)
  into the q third of ``w_qkv``. Its activation quantizations are
  dynamic per row, or, given calibrated amax, static per-layer scales
  folded into the weight dequant scales: the JAX engine's static modes
  "ln" (the post-LN inputs), "hidden" (+ the post-GELU hidden) and "full"
  (+ the attention context), each optionally with the calibrated softmax
  shift ("+score").

Same formulas, margins and op order as the JAX package, so the int8
weights are equal and the f32 scales agree to rounding (bitwise unfolded).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jcf_tpu_torch.ops.int8_gemm import int8_gemm_rowscale

# margins on the calibrated amax: the z-scored LN inputs, and the static
# ctx / hidden scales, whose per-row amax varies more
LN_MARGIN = 1.05
STATIC_MARGIN = 1.10


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device, as the JAX package
    divides: on CUDA, PyTorch multiplies by the reciprocal of a Python
    scalar divisor, which rounds differently now and then."""
    return x / x.new_tensor(c)


class QuantizedLinear(NamedTuple):
    w_int8: torch.Tensor  # [..., out, in] int8
    w_scale: torch.Tensor  # [..., out] f32 per-output-channel
    bias: torch.Tensor | None  # [..., out] f32


def quantize_weight(weight: torch.Tensor, bias: torch.Tensor | None = None) -> QuantizedLinear:
    """[..., out, in] float weight -> per-channel symmetric int8."""
    w = weight.float()
    scale = torch.clamp_min(true_div(w.abs().amax(dim=-1), 127.0), 1e-8)
    w_int8 = torch.clamp(torch.round(w / scale[..., None]), -127, 127).to(torch.int8)
    return QuantizedLinear(w_int8, scale, bias)


def quantize_rows(x: torch.Tensor):
    """Dynamic per-row symmetric int8 (``int8_linear``'s activation side):
    x [M, K] -> (int8 [M, K], f32 scales [M]) with
    ``scale = max(max|x| / 127, 1e-8)`` and ``round_half_even(x / scale)``
    (a true division) clipped to +-127, in f32. x is not copied to f32
    first: max|x| is exact in x's dtype, and the division promotes to f32."""
    amax = torch.linalg.vector_norm(x, float("inf"), dim=-1).float()
    x_scale = torch.clamp_min(true_div(amax, 127.0), 1e-8)
    q = torch.div(x, x_scale[:, None]).round_().clamp_(-127, 127)
    return q.to(torch.int8), x_scale


def int8_linear(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """Dynamic per-row activation quantization and an s8 x s8 -> s32
    product, then ``(acc * x_scale) * w_scale + bias`` in f32, cast to
    x's dtype: x [..., in] -> [..., out]. The product and epilogue are
    ``ops.int8_gemm.int8_gemm_rowscale`` (bf16 out on the card)."""
    x_q, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    y = int8_gemm_rowscale(x_q, q.w_int8, x_scale, q.w_scale, q.bias.float(), out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], -1)


def _fold_blocks(blocks: dict, n_heads: int, act, act_static) -> dict:
    """The folded tree of one tower's stacked blocks (``quant_blocks`` of
    the JAX function with ``fold=True``)."""
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
    tree = {
        "attn": {"w_qkv": quantize_weight(w_qkv, b_qkv),
                 "w_out": quantize_weight(blocks["attn"]["w_out"],
                                          blocks["attn"]["b_out"].float())},
        "mlp": {"c_fc": quantize_weight(w_fc, b_fc),
                "c_proj": quantize_weight(blocks["mlp"]["c_proj"]["w"],
                                          blocks["mlp"]["c_proj"]["b"].float())},
        "quant_folded": True,
    }
    if act is None:
        return tree
    a = torch.as_tensor(act, dtype=torch.float32, device=w_qkv.device) * LN_MARGIN
    attn, mlp = tree["attn"], tree["mlp"]

    def fold_scale(q: QuantizedLinear, amax: torch.Tensor) -> QuantizedLinear:
        return q._replace(w_scale=q.w_scale * true_div(amax, 127.0)[:, None])

    attn["ln_inv"] = (127.0 / a[:, 0]).reshape(-1, 1, 1)
    mlp["ln_inv"] = (127.0 / a[:, 1]).reshape(-1, 1, 1)
    attn["w_qkv"] = fold_scale(attn["w_qkv"], a[:, 0])
    mlp["c_fc"] = fold_scale(mlp["c_fc"], a[:, 1])
    if a.shape[1] >= 4:
        ah = a[:, 2:4] * (STATIC_MARGIN / LN_MARGIN)  # the reference's op order
        if "ctx" in act_static:
            attn["ctx_inv"] = (127.0 / ah[:, 0]).reshape(-1, 1, 1)
            attn["w_out"] = fold_scale(attn["w_out"], ah[:, 0])
        if "hidden" in act_static:
            mlp["h_inv"] = (127.0 / ah[:, 1]).reshape(-1, 1, 1)
            mlp["c_proj"] = fold_scale(mlp["c_proj"], ah[:, 1])
    if a.shape[1] >= 6 and "score" in act_static:
        # the calibrated score amax less 40 (e^48 of headroom under f32
        # overflow), at most the weakest calibrated row max + 80 (every
        # row's bf16 p stays above underflow), and not below 0
        shift = torch.minimum(true_div(a[:, 4], LN_MARGIN) - 40.0, a[:, 5] + 80.0)
        attn["score_shift"] = torch.clamp_min(shift, 0.0).reshape(-1, 1, 1)
    return tree


def quantize_clip_params(params: dict, *, fold: bool = False, heads: dict | None = None,
                         act_scales: dict | None = None,
                         act_static: tuple = ("ctx", "hidden")) -> dict:
    """Quantize the towers' block matmuls -> ``{"visual": tree, "text":
    tree}``, the JAX function's trees (one per tower of ``params``).

    Every tree says whether it is folded (``tree["quant_folded"]``), which
    is what the towers dispatch on.

    ``fold=False`` (the default): the unfolded tree of every tower in
    ``params`` (``{"attn": {"w_qkv", "w_out"}, "mlp": {"c_fc",
    "c_proj"}}`` of ``QuantizedLinear``); nothing else is read.
    ``fold=True``: the folded tree of each tower that ``heads`` names
    with its head count ({"visual": H_v, "text": H_t}; the JAX function
    needs both). Without ``act_scales`` every activation quantization is
    dynamic per row. ``act_scales={tower: amax}``, the calibrated
    per-layer amax (``models.clip.vision_ln_z_amax`` for the vision
    tower), adds static scales: [L, 2] (the LN-1 and LN-2 inputs) gives
    ``ln_inv``; [L, 4] (+ the attention context and the post-GELU hidden)
    also ``ctx_inv`` and ``h_inv`` as ``act_static`` names "ctx" and
    "hidden"; [L, 6] (+ the score amax and the weakest row's score max,
    ``with_scores=True``) also the max-free softmax shift ``score_shift``
    when ``act_static`` names "score". Each static scale's amax / 127
    folds into the weight dequant scale that consumes its quantized input.
    """
    act_scales = act_scales or {}
    if not fold:
        q = quantize_weight
        return {tower: {
            "attn": {"w_qkv": q(b["attn"]["w_qkv"], b["attn"]["b_qkv"]),
                     "w_out": q(b["attn"]["w_out"], b["attn"]["b_out"])},
            "mlp": {"c_fc": q(b["mlp"]["c_fc"]["w"], b["mlp"]["c_fc"]["b"]),
                    "c_proj": q(b["mlp"]["c_proj"]["w"], b["mlp"]["c_proj"]["b"])},
            "quant_folded": False,
        } for tower, b in ((t, params[t]["blocks"]) for t in ("visual", "text") if t in params)}
    if not heads:
        raise ValueError("fold=True needs heads={tower: head count} for the towers to fold")
    return {tower: _fold_blocks(params[tower]["blocks"], heads[tower], act_scales.get(tower),
                                act_static)
            for tower in ("visual", "text") if tower in heads}
