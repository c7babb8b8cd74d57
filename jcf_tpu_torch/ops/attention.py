"""Multi-head self-attention (``jcf_tpu/ops/attention.py``): K7, the
attention over the packed qkv projection, forward and backward, and K8,
the attention of sequences of 128 tokens or more.

``packed_attention`` is differentiable. Its forward launches a CUDA
kernel of ``csrc/packed_attn.cu`` (replaces ``_packed_attn_kernel``) and
its backward a backward kernel of the same file (replaces the XLA VJP of
``_packed_attention_ref``): each in bf16 at head dim 64 the tensor-core
kernel, else the CUDA-core one (``attention_route``, counted by route); on
CPU tensors both run their plain versions ``packed_attention_plain`` and
``packed_attention_bwd_plain``.

``fused_attention`` is K8 over [B, H, S, D] heads: on CUDA tensors it
launches a kernel of ``csrc/blocked_attn.cu`` (replaces
``_attn_kernel_blocked``; bf16 on the tensor cores, f32 register-tiled on
the CUDA cores, ``csrc/attn_f32.cuh``), on CPU tensors it runs
``attention_plain`` (JAX's ``_attention_xla``). Like the TPU kernel it has
no backward.

``multi_head_attention`` routes every sequence shorter than 128 through
K7 and longer ones through K8, as the JAX function does on a TPU.
"""

from __future__ import annotations

import math

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops.layers import linear
from jcf_tpu_torch.ops.quant import int8_linear
from jcf_tpu_torch.peft.lora import lora_out_adjustment, lora_qkv_adjustment

# the attention kernels' two routes: "mma" on the tensor cores (bf16 at
# head dim 64 with 16-byte aligned rows), "rowloop" on the CUDA cores
ROUTES = ("mma", "rowloop")
# launches of this module's kernels (CUDA tensors only); K7's forward and
# backward also by route, as "packed_attention/<route>" and
# "packed_attention_bwd/<route>"
LAUNCHES = {"packed_attention": 0, "packed_attention_bwd": 0, "blocked_attention": 0,
            **{f"{k}/{r}": 0 for k in ("packed_attention", "packed_attention_bwd")
               for r in ROUTES}}
# sequences this long or longer take K8, shorter ones K7
BLOCKED_MIN_SEQ = 128


def attention_route(dtype: torch.dtype, head_dim: int, *ptrs: int) -> str:
    """The route of an attention kernel that has both: "mma" (the tensor
    cores) for bf16 at head dim 64 with every pointer in ``ptrs`` 16-byte
    aligned, else "rowloop" (the CUDA cores; f32 products stay off the
    tensor cores, which would take them in TF32)."""
    aligned = all(p % 16 == 0 for p in ptrs)
    return "mma" if dtype == torch.bfloat16 and head_dim == 64 and aligned else "rowloop"


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Strictly-upper-triangular -inf mask [length, length] f32."""
    return torch.triu(torch.full((length, length), float("-inf"), device=device), diagonal=1)


def _heads(qkv: torch.Tensor, n_heads: int):
    """[B, S, 3E] -> q, k, v as f32 [B, H, S, D] views, and D."""
    b, s, e3 = qkv.shape
    d = e3 // 3 // n_heads
    q, k, v = qkv.float().reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    return q, k, v, d


def _full_bias(s: int, device, bias) -> torch.Tensor:
    """The additive [s, s] f32 bias on ``device``: zeros when None."""
    if bias is None:
        return torch.zeros((s, s), dtype=torch.float32, device=device)
    return bias.to(device, torch.float32)


def _probs(q, k, d, bias):
    """f32 scores x 1/sqrt(d) + bias, the row max (constant to autograd:
    softmax does not depend on it), exp and p / sum in f32."""
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d)) + bias
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True).detach())
    return p / p.sum(dim=-1, keepdim=True)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias=None) -> torch.Tensor:
    """K8's function in plain PyTorch (``_attention_xla``): q, k, v
    [B, H, S, D] (f32 or bf16) and an optional additive [S, S] bias ->
    [B, H, S, D] in q's dtype. Scores and softmax in f32, p cast to v's
    dtype for PV with f32 sums."""
    p = _probs(q.float(), k.float(), q.shape[-1], _full_bias(q.shape[2], q.device, bias))
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def packed_attention_plain(qkv: torch.Tensor, n_heads: int, bias=None) -> torch.Tensor:
    """K7's forward in plain PyTorch (``_packed_attention_ref``): qkv
    [B, S, 3E] (f32 or bf16) and an optional additive [S, S] bias ->
    [B, S, E] in qkv's dtype; p is cast to qkv's dtype for PV. Autograd
    through it is the reference of the backward kernel."""
    b, s, e3 = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, n_heads, e3 // 3 // n_heads).permute(2, 0, 3, 1, 4)
    return attention_plain(q, k, v, bias).permute(0, 2, 1, 3).reshape(b, s, e3 // 3)


def packed_attention_bwd_plain(qkv: torch.Tensor, n_heads: int, bias: torch.Tensor,
                               dout: torch.Tensor) -> torch.Tensor:
    """K7's backward in plain PyTorch: qkv [B, S, 3E], the [S, S] f32 bias
    and the output's cotangent dout [B, S, E] -> d qkv [B, S, 3E] in qkv's
    dtype. P is recomputed; dP = dO V^T is rounded to qkv's dtype (the
    cotangent of the cast of p); dS = P (dP - rowsum(P dP)) / sqrt(d);
    dQ = dS K, dK = dS^T Q, dV = T(P)^T dO, each cast to qkv's dtype."""
    b, s, e3 = qkv.shape
    dt = qkv.dtype
    q, k, v, d = _heads(qkv, n_heads)
    do = dout.float().reshape(b, s, n_heads, d).transpose(1, 2)
    p = _probs(q, k, d, _full_bias(s, qkv.device, bias))
    dp = torch.matmul(do, v.transpose(-1, -2)).to(dt).float()
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * (1.0 / math.sqrt(d))
    grads = (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
             torch.matmul(p.to(dt).float().transpose(-1, -2), do))
    return torch.stack([g.to(dt) for g in grads], dim=2).permute(0, 3, 2, 1, 4).reshape(b, s, e3)


def _kernel_args(qkv: torch.Tensor, n_heads: int, bias: torch.Tensor):
    """Checks the types and shapes the kernels take -> (B, S, H, D). The C
    entries refuse S > 128 and a block over the card's shared memory
    themselves (``cudaErrorInvalidValue``, raised by ``_build.check``)."""
    if qkv.dtype not in (torch.float32, torch.bfloat16) or qkv.dim() != 3:
        raise ValueError(f"K7 takes f32 or bf16 qkv [B, S, 3E], got {qkv.dtype} {tuple(qkv.shape)}")
    b, s, e3 = qkv.shape
    if e3 % (3 * n_heads):
        raise ValueError(f"3E = {e3} is not a multiple of 3 x {n_heads} heads")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (s, s) or bias.device != qkv.device:
        raise ValueError(f"bias must be f32 ({s}, {s}) on qkv's device")
    return b, s, n_heads, e3 // 3 // n_heads


def packed_attention_fwd(qkv: torch.Tensor, n_heads: int, bias: torch.Tensor) -> torch.Tensor:
    """K7's forward kernel for CUDA tensors, its plain version for CPU
    tensors: qkv [B, S, 3E], bias [S, S] f32 -> [B, S, E]. bf16 at head
    dim 64 with 16-byte aligned qkv takes the tensor-core kernel, anything
    else the CUDA-core one (``attention_route``)."""
    if not qkv.is_cuda:
        return packed_attention_plain(qkv, n_heads, bias)
    b, s, h, d = _kernel_args(qkv, n_heads, bias)
    qkv, bias = qkv.contiguous(), bias.contiguous()
    out = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    route = attention_route(qkv.dtype, d, qkv.data_ptr(), out.data_ptr())
    lib = _build.load()
    err = lib.jcf_packed_attention(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, s, h, d,
                                   1.0 / math.sqrt(d), int(qkv.dtype == torch.bfloat16),
                                   int(route == "mma"), _build.stream_ptr(qkv.device))
    _build.check(err, "packed_attention")
    LAUNCHES["packed_attention"] += 1
    LAUNCHES[f"packed_attention/{route}"] += 1
    return out


def packed_attention_bwd(qkv: torch.Tensor, n_heads: int, bias: torch.Tensor,
                         dout: torch.Tensor) -> torch.Tensor:
    """K7's backward kernel for CUDA tensors, its plain version for CPU
    tensors: -> d qkv [B, S, 3E] in qkv's dtype."""
    if not qkv.is_cuda:
        return packed_attention_bwd_plain(qkv, n_heads, bias, dout)
    b, s, h, d = _kernel_args(qkv, n_heads, bias)
    if dout.dtype != qkv.dtype or tuple(dout.shape) != (b, s, h * d) or dout.device != qkv.device:
        raise ValueError(f"dout must be {qkv.dtype} ({b}, {s}, {h * d}) on qkv's device")
    qkv, bias, dout = qkv.contiguous(), bias.contiguous(), dout.contiguous()
    dqkv = torch.empty_like(qkv)
    route = attention_route(qkv.dtype, d, qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr())
    lib = _build.load()
    err = lib.jcf_packed_attention_bwd(qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(),
                                       dqkv.data_ptr(), b, s, h, d, 1.0 / math.sqrt(d),
                                       int(qkv.dtype == torch.bfloat16), int(route == "mma"),
                                       _build.stream_ptr(qkv.device))
    _build.check(err, "packed_attention_bwd")
    LAUNCHES["packed_attention_bwd"] += 1
    LAUNCHES[f"packed_attention_bwd/{route}"] += 1
    return dqkv


class _PackedAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; the
    bias is a constant and gets none."""

    @staticmethod
    def forward(ctx, qkv, bias, n_heads):
        ctx.save_for_backward(qkv, bias)
        ctx.n_heads = n_heads
        return packed_attention_fwd(qkv, n_heads, bias)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        return packed_attention_bwd(qkv, ctx.n_heads, bias, dout.to(qkv.dtype)), None, None


def packed_attention(qkv: torch.Tensor, n_heads: int, bias=None) -> torch.Tensor:
    """[B, S, 3E] packed qkv -> [B, S, E] attention context in qkv's dtype,
    differentiable in qkv. ``bias`` is an optional additive [S, S] mask
    (the text tower's causal mask); zeros when None."""
    return _PackedAttention.apply(qkv, _full_bias(qkv.shape[1], qkv.device, bias), n_heads)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias=None) -> torch.Tensor:
    """K8: ``softmax(q k^T / sqrt(D) + bias) v`` over q, k, v [B, H, S, D]
    (f32 or bf16, one dtype) with an optional additive f32 [S, S] bias ->
    [B, H, S, D] in q's dtype. CUDA tensors launch the kernel (D = 64,
    S <= 768; q, k and v may be any views with one set of strides and a
    contiguous head dim, with 16-byte aligned rows: pointers on 16 bytes
    and strides of whole 16-byte steps, 8 bf16 or 4 f32 elements; the
    result is a [B, H, S, D] view of a packed [B, S, H, D] tensor); CPU
    tensors run ``attention_plain``."""
    if not q.is_cuda:
        return attention_plain(q, k, v, bias)
    if q.dtype not in (torch.float32, torch.bfloat16) or q.dim() != 4:
        raise ValueError(f"K8 takes f32 or bf16 q [B, H, S, D], got {q.dtype} {tuple(q.shape)}")
    for t in (k, v):
        if t.dtype != q.dtype or t.shape != q.shape or t.stride() != q.stride() or t.device != q.device:
            raise ValueError("K8 takes q, k and v of one dtype, shape, stride and device")
    if q.shape[-1] != 64 or q.stride(-1) != 1:
        raise ValueError(f"K8 takes a contiguous head dim of 64, got {q.shape[-1]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("K8 has no backward (nor has the TPU kernel it replaces)")
    b, h, s, d = q.shape
    step = 16 // q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any(st % step for st in q.stride()[:3]):
        raise ValueError(f"K8 takes 16-byte aligned rows, got strides {q.stride()} "
                         f"and offsets {[t.data_ptr() % 16 for t in (q, k, v)]} bytes")
    if bias is not None:
        if bias.dtype != torch.float32 or tuple(bias.shape) != (s, s) or bias.device != q.device:
            raise ValueError(f"bias must be f32 ({s}, {s}) on q's device")
        bias = bias.contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lib = _build.load()
    err = lib.jcf_blocked_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    bias.data_ptr() if bias is not None else None, out.data_ptr(),
                                    b, s, h, d, *q.stride()[:3], *out.stride()[:3],
                                    1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
                                    _build.stream_ptr(q.device))
    _build.check(err, "blocked_attention")
    LAUNCHES["blocked_attention"] += 1
    return out


def multi_head_attention(x: torch.Tensor, params: dict, n_heads: int,
                         mask: torch.Tensor | None = None, *,
                         lora: dict | None = None, quant: dict | None = None) -> torch.Tensor:
    """Self-attention over batch-first [B, S, E] with the packed CLIP
    in-projection ``w_qkv [3E, E]`` / ``b_qkv [3E]``: through K7 below 128
    tokens, K8 from 128 on.

    lora: this layer's decomposed LoRA context, ``{"layer": {a_qkv, b_qkv
    [, a_out, b_out]}, "gate", "proj_mask", "spec", "generator"}`` (the
    training path; for inference merge the factors instead). K8 has no
    backward, so it takes no LoRA context.
    quant: this layer's unfolded int8 leaves ``{"w_qkv", "w_out"}``
    (``QuantizedLinear``, ``quantize_clip_params(fold=False)``): both
    projections become dynamic per-row int8 linears."""
    b, s, e = x.shape
    if s >= BLOCKED_MIN_SEQ and lora is not None:
        raise NotImplementedError("training at 128 tokens or more needs a backward of K8, "
                                  "which the JAX package does not have either")
    if quant is not None:
        qkv = int8_linear(x, quant["w_qkv"])
    else:
        qkv = linear(x, params["w_qkv"], params["b_qkv"])
    if lora is not None:
        qkv = qkv + lora_qkv_adjustment(x, lora["layer"], lora["spec"], lora["gate"],
                                        lora["proj_mask"], lora["generator"])
    if s < BLOCKED_MIN_SEQ:
        out = packed_attention(qkv, n_heads, mask)
    else:
        q, k, v = qkv.reshape(b, s, 3, n_heads, e // n_heads).permute(2, 0, 3, 1, 4)
        out = fused_attention(q, k, v, mask).transpose(1, 2).reshape(b, s, e)
    if quant is not None:
        y = int8_linear(out, quant["w_out"])
    else:
        y = linear(out, params["w_out"], params["b_out"])
    if lora is not None and "a_out" in lora["layer"]:
        y = y + lora_out_adjustment(out, lora["layer"], lora["spec"], lora["gate"],
                                    lora["generator"])
    return y
