"""The tower halves and the loops over the towers
(``jcf_tpu/ops/block_kernel.py``).

int8 attention half (K3), on a flat dense row stream x [B' * S, E] bf16:
  LN z-norm -> static int8 quant -> s8 qkv GEMM -> dequant + bias -> bf16
  -> per-crop attention (q pre-scaled, pair shift, PV on unnormalized bf16
  p, normalizer x ctx_inv) -> int8 ctx -> s8 out-proj -> dequant + bias
  + f32 residual -> bf16.
int8 MLP half (K4):
  LN z-norm -> static int8 quant -> s8 c_fc (h_inv folded) -> QuickGELU
  in tanh form in the quantized domain -> int8 -> s8 c_proj -> dequant +
  bias + f32 residual -> bf16.
int8 CLS-query attention half of the last layer (K5): K/V for all rows,
  Q, attention, out-proj and residual for the CLS rows only.
bf16 attention half (K6a), the text tower's:
  LN (affine cast to bf16, f32 math) -> bf16 qkv GEMM + f32 bias -> causal
  attention (f32 softmax, normalized p cast to bf16 for PV) -> bf16 ctx
  -> out-proj + bias + f32 residual -> bf16.
bf16 MLP half (K6b):
  LN -> c_fc + bias -> QuickGELU (tanh form, f32) -> bf16 -> c_proj +
  bias + f32 residual -> bf16.

Each half is a few kernel launches: the row kernels ``ln_quant`` and
``ln_affine``, the attention kernels ``attention``, ``cls_attention``
(csrc/block.cu) and ``causal_attention`` (csrc/text_block.cu), and the
GEMMs with fused epilogues (csrc/int8_gemm.cu, csrc/bf16_gemm.cu). Each
wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors.

``run_fused_tower`` is the serving route of the JAX function: dense rows,
``cls_only``, folded weights, static scales in mode "full", and the last
layer as in ``_CLS_ATTNQ = True`` (K5, then the MLP half on the CLS rows).
``run_text_tower`` is its causal bf16 route (``encode_text``). The other
quant modes are not ported (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops.attention import causal_mask
from jcf_tpu_torch.ops.bf16_gemm import bf16_gemm_bias, bf16_gemm_gelu, bf16_gemm_residual
from jcf_tpu_torch.ops.int8_gemm import (
    int8_gemm_bf16,
    int8_gemm_gelu_quant,
    int8_gemm_residual,
)
from jcf_tpu_torch.ops.layers import GELU_TANH_COEF, LN_EPS, layer_slice

# launches of this module's kernels (CUDA tensors only)
LAUNCHES = {"ln_quant": 0, "attention": 0, "cls_attention": 0, "ln_affine": 0,
            "causal_attention": 0}


# ---------------------------------------------------------------------------
# LayerNorm z-norm + static quant
# ---------------------------------------------------------------------------


def _z_rows(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) per row, statistics in f32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + LN_EPS)


def ln_quant_plain(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """int8(round(((x - mean) * rsqrt(var + eps)) * inv)) per row, the LN
    affine folded away; statistics in f32."""
    return torch.clamp(torch.round(_z_rows(x) * inv.reshape(())), -127, 127).to(torch.int8)


def ln_quant(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """x [M, E] bf16, inv a one-element f32 tensor -> int8 [M, E]."""
    if not x.is_cuda:
        return ln_quant_plain(x, inv)
    m, e = x.shape
    if x.dtype != torch.bfloat16 or e > 1024:
        raise ValueError(f"ln_quant kernel takes bf16 rows with E <= 1024, got {x.dtype} E={e}")
    if inv.numel() != 1 or inv.dtype != torch.float32 or inv.device != x.device:
        raise ValueError("inv must be a one-element f32 tensor on the rows' device")
    x = x.contiguous()
    out = torch.empty((m, e), dtype=torch.int8, device=x.device)
    lib = _build.load()
    err = lib.jcf_ln_quant(x.data_ptr(), inv.data_ptr(), out.data_ptr(), m, e,
                           _build.stream_ptr(x.device))
    _build.check(err, "ln_quant")
    LAUNCHES["ln_quant"] += 1
    return out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_plain(qkv: torch.Tensor, ctx_inv: torch.Tensor, s: int, n_heads: int) -> torch.Tensor:
    """Plain version of the attention kernel: qkv [B' * S, 3E] bf16 (q
    pre-scaled by 1/sqrt(d)) -> int8 context [B' * S, E] with ctx_inv
    folded into the normalizer.

    The softmax shift is max(0, max over the head PAIR's scores): the
    reference's paired TPU layout takes one max per pair over both heads
    and the zeroed pad keys. The shift cancels in real arithmetic, but it
    moves the bf16 rounding of p, so it is kept exactly."""
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    b = rows // s
    t = qkv.float().reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)  # [3, B, H, S, D]
    q, k, v = t[0], t[1], t[2]
    scores = torch.matmul(q, k.transpose(-1, -2))  # [B, H, S, S]
    pair = scores.reshape(b, n_heads // 2, 2, s, s)
    m = pair.amax(dim=(2, 4), keepdim=True).clamp_min(0.0)
    p = torch.exp(pair - m).to(torch.bfloat16).float().reshape(b, n_heads, s, s)
    ctx_u = torch.matmul(p, v)  # [B, H, S, D]
    sums = p.sum(dim=-1, keepdim=True)
    ctx = ctx_u * (ctx_inv.reshape(()) / torch.clamp_min(sums, 1e-30))
    q8 = torch.clamp(torch.round(ctx), -127, 127).to(torch.int8)
    return q8.permute(0, 2, 1, 3).reshape(rows, e)


def attention(qkv: torch.Tensor, ctx_inv: torch.Tensor, s: int, n_heads: int) -> torch.Tensor:
    """Attention wrapper: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not qkv.is_cuda:
        return attention_plain(qkv, ctx_inv, s, n_heads)
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    if qkv.dtype != torch.bfloat16 or rows % s or n_heads % 2 or s > 64:
        raise ValueError(
            f"attention kernel takes bf16 qkv, S <= 64 and an even head count; "
            f"got {qkv.dtype}, S={s}, H={n_heads}, D={d}"
        )
    if ctx_inv.numel() != 1 or ctx_inv.dtype != torch.float32 or ctx_inv.device != qkv.device:
        raise ValueError("ctx_inv must be a one-element f32 tensor on the qkv device")
    qkv = qkv.contiguous()
    out = torch.empty((rows, e), dtype=torch.int8, device=qkv.device)
    lib = _build.load()
    err = lib.jcf_attention(qkv.data_ptr(), ctx_inv.data_ptr(), out.data_ptr(), rows // s, s,
                            n_heads, d, _build.stream_ptr(qkv.device))
    _build.check(err, "attention")
    LAUNCHES["attention"] += 1
    return out


def cls_attention_plain(q: torch.Tensor, kv: torch.Tensor, ctx_inv: torch.Tensor, s: int,
                        n_heads: int) -> torch.Tensor:
    """Plain version of the CLS-query attention kernel (K5): q [B', E]
    bf16 CLS queries (1/sqrt(d) folded), kv [B' * S, 2E] bf16 keys and
    values of all rows -> int8 context [B', E] with ctx_inv folded into
    the normalizer.

    The shift is the max over the head pair's scores and, when S < 64,
    the zero-padded keys' 0 (``_attn_cls_int8_kernel`` pads each head to
    64 keys). PV takes bf16 p, the normalizer sums the f32 p."""
    b, e = q.shape
    d = e // n_heads
    k, v = kv.float().reshape(b, s, 2, n_heads, d).permute(2, 0, 3, 1, 4)  # [B, H, S, D]
    scores = torch.matmul(q.float().reshape(b, n_heads, 1, d), k.transpose(-1, -2))
    pair = scores.reshape(b, n_heads // 2, 2, 1, s)
    m = pair.amax(dim=(2, 4), keepdim=True)
    if s < 64:
        m = m.clamp_min(0.0)
    p = torch.exp(pair - m).reshape(b, n_heads, 1, s)
    ctx_u = torch.matmul(p.to(torch.bfloat16).float(), v)  # [B, H, 1, D]
    ctx = ctx_u * (ctx_inv.reshape(()) / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30))
    return torch.clamp(torch.round(ctx), -127, 127).to(torch.int8).reshape(b, e)


def cls_attention(q: torch.Tensor, kv: torch.Tensor, ctx_inv: torch.Tensor, s: int,
                  n_heads: int) -> torch.Tensor:
    """CLS-query attention wrapper: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not q.is_cuda:
        return cls_attention_plain(q, kv, ctx_inv, s, n_heads)
    b, e = q.shape
    if (q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16 or e != 64 * n_heads
            or n_heads % 2 or s > 64 or tuple(kv.shape) != (b * s, 2 * e)):
        raise ValueError(f"cls_attention kernel takes bf16 q [B, E] and kv [B * S, 2E] with "
                         f"head dim 64, an even head count and S <= 64; got q {q.dtype} "
                         f"{tuple(q.shape)}, kv {kv.dtype} {tuple(kv.shape)}, S={s}, H={n_heads}")
    if ctx_inv.numel() != 1 or ctx_inv.dtype != torch.float32 or ctx_inv.device != q.device:
        raise ValueError("ctx_inv must be a one-element f32 tensor on the q device")
    q, kv = q.contiguous(), kv.contiguous()
    out = torch.empty((b, e), dtype=torch.int8, device=q.device)
    lib = _build.load()
    err = lib.jcf_cls_attention(q.data_ptr(), kv.data_ptr(), ctx_inv.data_ptr(), out.data_ptr(),
                                b, s, n_heads, _build.stream_ptr(q.device))
    _build.check(err, "cls_attention")
    LAUNCHES["cls_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# LayerNorm with its affine, and causal attention (the bf16 text halves)
# ---------------------------------------------------------------------------


def ln_affine_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``_ln_rows``: f32 statistics and affine on bf16 rows with the LN
    scale and bias already cast to bf16 -> bf16."""
    return (_z_rows(x) * scale.float() + bias.float()).to(torch.bfloat16)


def ln_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [M, E] bf16, scale and bias [E] bf16 -> bf16 [M, E]."""
    if not x.is_cuda:
        return ln_affine_plain(x, scale, bias)
    m, e = x.shape
    if x.dtype != torch.bfloat16 or e > 1024:
        raise ValueError(f"ln_affine kernel takes bf16 rows with E <= 1024, got {x.dtype} E={e}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (e,) or t.device != x.device:
            raise ValueError(f"{name} must be bf16 ({e},) on the rows' device")
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    out = torch.empty((m, e), dtype=torch.bfloat16, device=x.device)
    lib = _build.load()
    err = lib.jcf_ln_affine(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), m, e,
                            _build.stream_ptr(x.device))
    _build.check(err, "ln_affine")
    LAUNCHES["ln_affine"] += 1
    return out


def causal_attention_plain(qkv: torch.Tensor, s: int, n_heads: int) -> torch.Tensor:
    """Plain version of the causal attention kernel (``_paired_attention``
    with the additive causal mask, per head): qkv [B * S, 3E] bf16 ->
    context [B * S, E] bf16. f32 scores x 1/sqrt(d), the mask, a per-head
    max, exp and sum in f32, p / sum in f32, then bf16 p for PV."""
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    b = rows // s
    q, k, v = qkv.float().reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)  # [B, H, S, D]
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d)) + causal_mask(s, qkv.device)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(p.to(torch.bfloat16).float(), v)  # [B, H, S, D]
    return ctx.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(rows, e)


def causal_attention(qkv: torch.Tensor, s: int, n_heads: int) -> torch.Tensor:
    """Causal attention wrapper: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not qkv.is_cuda:
        return causal_attention_plain(qkv, s, n_heads)
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    if qkv.dtype != torch.bfloat16 or rows % s or s > 128 or d % 8 or e != d * n_heads:
        raise ValueError(f"causal attention kernel takes bf16 qkv, S <= 128 and a head dim "
                         f"divisible by 8; got {qkv.dtype}, rows={rows}, S={s}, H={n_heads}, D={d}")
    qkv = qkv.contiguous()
    out = torch.empty((rows, e), dtype=torch.bfloat16, device=qkv.device)
    lib = _build.load()
    err = lib.jcf_causal_attention(qkv.data_ptr(), out.data_ptr(), rows // s, s, n_heads, d,
                                   1.0 / math.sqrt(d), _build.stream_ptr(qkv.device))
    _build.check(err, "causal_attention")
    LAUNCHES["causal_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# the halves and the tower
# ---------------------------------------------------------------------------


def attn_half_int8(x: torch.Tensor, attn: dict, s: int, n_heads: int) -> torch.Tensor:
    """K3 on dense rows x [B' * S, E] bf16 with one layer's folded static
    attention weights -> x + attention(x), bf16."""
    x_q = ln_quant(x, attn["ln_inv"])
    wq = attn["w_qkv"]
    qkv = int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias)
    ctx = attention(qkv, attn["ctx_inv"], s, n_heads)
    wo = attn["w_out"]
    return int8_gemm_residual(ctx, wo.w_int8, wo.w_scale, wo.bias, x)


def mlp_half_int8(x: torch.Tensor, mlp: dict) -> torch.Tensor:
    """K4 on rows x [M, E] bf16 with one layer's folded static MLP weights
    -> x + mlp(x), bf16. The static hidden scale h_inv folds into the
    c_fc dequant scale and bias (``_fold_h_static``), so the GEMM lands in
    the quantized domain and QuickGELU runs there."""
    h_inv = mlp["h_inv"].reshape(())
    fc, pr = mlp["c_fc"], mlp["c_proj"]
    x_q = ln_quant(x, mlp["ln_inv"])
    gelu_c = GELU_TANH_COEF / h_inv
    h_q = int8_gemm_gelu_quant(x_q, fc.w_int8, fc.w_scale * h_inv, fc.bias * h_inv, gelu_c)
    return int8_gemm_residual(h_q, pr.w_int8, pr.w_scale, pr.bias, x)


def attn_cls_int8(x: torch.Tensor, attn: dict, s: int, n_heads: int) -> torch.Tensor:
    """K5 on dense rows x [B' * S, E] bf16 with the last layer's folded
    static attention weights -> the CLS rows of x + attention(x), [B', E]
    bf16 (``_attn_cls_int8_kernel``). LN and quant run on all rows, K/V
    (rows e:3e of w_qkv) on all rows, Q (rows :e) on the CLS rows only."""
    e = x.shape[1]
    x_q = ln_quant(x, attn["ln_inv"])
    wq = attn["w_qkv"]
    kv = int8_gemm_bf16(x_q, wq.w_int8[e:], wq.w_scale[e:], wq.bias[e:])
    q = int8_gemm_bf16(x_q[::s].contiguous(), wq.w_int8[:e], wq.w_scale[:e], wq.bias[:e])
    ctx = cls_attention(q, kv, attn["ctx_inv"], s, n_heads)
    wo = attn["w_out"]
    return int8_gemm_residual(ctx, wo.w_int8, wo.w_scale, wo.bias, x[::s].contiguous())


def run_fused_tower(x: torch.Tensor, quant: dict, n_heads: int, *, flat_s: int) -> torch.Tensor:
    """All layers over flat dense rows x [B' * S, E] bf16 -> CLS rows [B', E].

    ``quant`` is the folded static tree of ``quantize_clip_params`` (layers
    stacked on the leading axis). Layers 0..L-2 run both halves on all
    rows; the last layer runs K5 (the CLS rows attend to every token) and
    its MLP half on the CLS rows only, since nothing downstream reads the
    other rows.
    """
    s = flat_s
    n_layers = quant["attn"]["w_qkv"].w_int8.shape[0]
    for i in range(n_layers - 1):
        layer = layer_slice(quant, i)
        x = attn_half_int8(x, layer["attn"], s, n_heads)
        x = mlp_half_int8(x, layer["mlp"])
    last = layer_slice(quant, n_layers - 1)
    return mlp_half_int8(attn_cls_int8(x, last["attn"], s, n_heads), last["mlp"])


def attn_half(x: torch.Tensor, layer: dict, s: int, n_heads: int) -> torch.Tensor:
    """K6a on rows x [B * S, E] bf16 (S rows per sequence) with one
    layer's float block params -> x + causal attention(LN1(x)), bf16.
    Weights are cast to bf16, biases kept f32 (``_halves_block``)."""
    bf = torch.bfloat16
    ln, attn = layer["ln_1"], layer["attn"]
    h = ln_affine(x, ln["scale"].to(bf), ln["bias"].to(bf))
    qkv = bf16_gemm_bias(h, attn["w_qkv"].to(bf), attn["b_qkv"].float())
    ctx = causal_attention(qkv, s, n_heads)
    return bf16_gemm_residual(ctx, attn["w_out"].to(bf), attn["b_out"].float(), x)


def mlp_half(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """K6b on rows x [M, E] bf16 -> x + c_proj(QuickGELU(c_fc(LN2(x)))), bf16."""
    bf = torch.bfloat16
    ln, mlp = layer["ln_2"], layer["mlp"]
    h = ln_affine(x, ln["scale"].to(bf), ln["bias"].to(bf))
    hidden = bf16_gemm_gelu(h, mlp["c_fc"]["w"].to(bf), mlp["c_fc"]["b"].float())
    return bf16_gemm_residual(hidden, mlp["c_proj"]["w"].to(bf), mlp["c_proj"]["b"].float(), x)


def run_text_tower(x: torch.Tensor, blocks: dict, n_heads: int, *, s: int) -> torch.Tensor:
    """The causal bf16 route of ``run_fused_tower`` (every TPU
    ``encode_text``): rows x [B * S, E] bf16 through all layers of the
    stacked float ``blocks`` -> [B * S, E] bf16. The TPU pads S = 77 to
    80 with keys masked by -1e30; they never reach real rows, so the port
    runs unpadded."""
    for i in range(blocks["attn"]["w_qkv"].shape[0]):
        layer = layer_slice(blocks, i)
        x = attn_half(x, layer, s, n_heads)
        x = mlp_half(x, layer)
    return x
