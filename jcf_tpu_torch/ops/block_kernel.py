"""K3/K4: the int8 tower halves and the loop over the tower
(``jcf_tpu/ops/block_kernel.py``).

Attention half (K3), on a flat dense row stream x [B' * S, E] bf16:
  LN z-norm -> static int8 quant -> s8 qkv GEMM -> dequant + bias -> bf16
  -> per-crop attention (q pre-scaled, pair shift, PV on unnormalized bf16
  p, normalizer x ctx_inv) -> int8 ctx -> s8 out-proj -> dequant + bias
  + f32 residual -> bf16.
MLP half (K4):
  LN z-norm -> static int8 quant -> s8 c_fc (h_inv folded) -> QuickGELU
  in tanh form in the quantized domain -> int8 -> s8 c_proj -> dequant +
  bias + f32 residual -> bf16.

Each half is a few kernel launches: ``ln_quant`` (csrc/block.cu), the int8
GEMM with fused epilogues (csrc/int8_gemm.cu) and ``attention``
(csrc/block.cu). Each wrapper launches its kernel for CUDA tensors and
runs its plain version for CPU tensors.

``run_fused_tower`` is the serving route of the JAX function: dense rows,
``cls_only``, folded weights, static scales in mode "full", and the last
layer as in ``_CLS_ATTNQ = False`` (its attention half on all rows, its
MLP half on the gathered CLS rows). The CLS-query last-layer kernel (K5)
and the other quant modes are not ported (ROADMAP.md).
"""

from __future__ import annotations

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops.int8_gemm import (
    int8_gemm_bf16,
    int8_gemm_gelu_quant,
    int8_gemm_residual,
)
from jcf_tpu_torch.ops.layers import LN_EPS, layer_slice

# QuickGELU x * sigmoid(1.702 x) == x * (0.5 + 0.5 tanh(0.851 x)), the
# form the reference kernels use
GELU_TANH_COEF = 0.851
# launches of this module's kernels (CUDA tensors only)
LAUNCHES = {"ln_quant": 0, "attention": 0}


# ---------------------------------------------------------------------------
# LayerNorm z-norm + static quant
# ---------------------------------------------------------------------------


def ln_quant_plain(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """int8(round(((x - mean) * rsqrt(var + eps)) * inv)) per row, the LN
    affine folded away; statistics in f32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    z = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return torch.clamp(torch.round(z * inv.reshape(())), -127, 127).to(torch.int8)


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


def run_fused_tower(x: torch.Tensor, quant: dict, n_heads: int, *, flat_s: int) -> torch.Tensor:
    """All layers over flat dense rows x [B' * S, E] bf16 -> CLS rows [B', E].

    ``quant`` is the folded static tree of ``quantize_clip_params`` (layers
    stacked on the leading axis). Layers 0..L-2 run both halves on all
    rows; the last layer runs its attention half on all rows (the CLS row
    attends to every token) and its MLP half on the gathered CLS rows only,
    since nothing downstream reads the other rows.
    """
    s = flat_s
    n_layers = quant["attn"]["w_qkv"].w_int8.shape[0]
    for i in range(n_layers - 1):
        layer = layer_slice(quant, i)
        x = attn_half_int8(x, layer["attn"], s, n_heads)
        x = mlp_half_int8(x, layer["mlp"])
    last = layer_slice(quant, n_layers - 1)
    x = attn_half_int8(x, last["attn"], s, n_heads)
    return mlp_half_int8(x[::s].contiguous(), last["mlp"])
