"""The tower halves and the loops over the towers
(``jcf_tpu/ops/block_kernel.py``).

int8 attention half (K3), on rows x [B' * S, E] in bf16 (the vision
towers, a bf16 text tower) or f32 (the f32 text tower), S <= 127:
  LN (the z-norm on the folded tree; with its affine on the unfolded
  tree) -> int8 quant (static ``ln_inv``, or dynamic per row) -> s8 qkv
  GEMM -> dequant (x the row scales) + bias -> bf16 -> per-crop attention
  -> int8 ctx (static ``ctx_inv``; or the f32 context quantized per row)
  -> s8 out-proj -> dequant + bias + f32 residual -> x's dtype.
  The attention is the reference's mask-free paired one (an even head
  count without a mask: scores x 1/sqrt(d) on the unfolded tree, the
  folded q carries it; shift max(floor, pair max), floor 0 on the dense
  route (S not a multiple of 16, whose zeroed pad keys score 0) and none
  on the non-dense route (S a multiple of 16), or the calibrated
  ``score_shift``; PV on unnormalized bf16 p; normalizer x ctx_inv), or
  its masked one (``use_mask=True``: the causal text tower, or an odd
  head count: per head, p normalized in f32 then cast to bf16 for PV,
  the static ctx scale a post-multiply; no shift).
int8 MLP half (K4):
  LN (as in K3) -> int8 quant (static or dynamic) -> s8 c_fc, then either
  the static hidden scale h_inv folded in and QuickGELU (tanh form) in
  the quantized domain, or the f32 hidden, QuickGELU and a dynamic row
  quantization per row and hidden chunk (``_MLP_NSPLIT`` chunks; one for
  the CLS rows) -> int8 -> s8 c_proj, one f32 partial a chunk added in
  chunk order -> dequant (x the row scales) + bias + f32 residual -> x's
  dtype.
int8 CLS-query attention half of the last layer (K5), dense route, S <=
  64: K/V for all rows, Q, attention, out-proj and residual for the CLS
  rows only, in the same quantization modes, folded or unfolded.
float attention half (K6a), in the compute dtype T (bf16 or f32):
  LN (affine cast to T, f32 math) -> T qkv GEMM + f32 bias -> causal
  attention (the text tower) or per-head attention without a mask (an
  odd head count; both: f32 softmax per head, normalized p cast to T for
  PV) or mask-free paired attention (the float vision towers: scores x
  1/sqrt(d), one shift per head pair, PV on unnormalized p in T) -> T ctx
  -> out-proj + bias + f32 residual -> T.
float MLP half (K6b):
  LN -> c_fc + bias -> QuickGELU (tanh form, f32) -> T -> c_proj + bias +
  f32 residual -> T.

Each half is a few kernel launches: the row kernels ``ln_quant``,
``ln_quant_rows``, ``ln_affine_quant_rows``, ``quant_rows`` and
``ln_affine``, the attention kernels ``attention``, ``cls_attention``
(csrc/block.cu), ``masked_attention`` (its float variants
``causal_attention`` and ``head_attention``) and ``pair_attention``
(csrc/text_block.cu), and the GEMMs with fused epilogues
(csrc/int8_gemm.cu; for the float halves csrc/bf16_gemm.cu and
csrc/f32_gemm.cu, all three on wgmma fed by TMA, the f32 products as three
TF32 products). Each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors. ``attention`` and ``masked_attention`` on bf16 qkv at head dim
64 launch tensor-core kernels (csrc/pair_mma.cuh, csrc/text_block.cu),
other head dims the CUDA-core row loops, and count each launch by its
route too (``attention_route``); on f32 qkv ``masked_attention`` takes
head dim 64 only, register-tiled on the CUDA cores (csrc/attn_f32.cuh,
K8's f32 kernel), and ``pair_attention`` takes head dim 64 only, bf16 on
the tensor cores and f32 register-tiled on the CUDA cores. A static
scale the tree lacks is dynamic. The folded tree's modes
(``ops.quant.quantize_clip_params(fold=True)``): every scale dynamic;
"ln" (static post-LN scales); "hidden" (+ the hidden's); "full" (+ the
context's); each of the three optionally "+score" (the shift).
The unfolded tree (``fold=False``) keeps every scale dynamic and reads
the LN affine from the float blocks.

Whole layers in one kernel, the TPU's ``_FUSE`` variants of the same
math: the int8 kernels
  K9a ``block_int8`` (``_block_int8_kernel``): one int8 layer, the mid
  residual kept in f32 (the halves round it to bf16);
  K9d ``layer_fused_int8`` (``_layer_fused_int8_kernel``): one int8 layer,
  bf16 mid, the MLP in ``_LAYER_NSPLIT`` hidden chunks;
  K9c ``stream_tower_int8`` (``_stream_tower_int8_kernel``): every int8
  layer on every row in one launch, bf16 mid;
each one persistent cooperative launch (csrc/block_int8.cu, one template
over the rows, the mid, the masked attention's code and the mode, the
attention's kind read at run time): the halves' phases over all the rows (LN + quant, the products on
wgmma with the int8 GEMM's epilogues, the pair or the masked attention,
the row quantizations, their device code shared with K3 / K4), separated
by grid barriers; a layer a launch (K9a, K9d) or the whole tower (K9c),
whose layers at one hidden chunk equal the halves' bit for bit (K9d is
K9c's one-layer launch);
and K9b (``_block_kernel``, csrc/block_float.cu, one template over the
rows' type): ``block_bf16`` and ``block_f32``, one float layer with an
additive [S, S] bias, f32 mid, QuickGELU in its sigmoid form; one
persistent launch a layer whose phases (the LayerNorms, the four
products on wgmma, f32 as three TF32 products, the attention) walk all
the rows, separated by grid barriers.
The MLP's f32 chunk partials (``_MLP_NSPLIT`` for K9a/K9c and the
halves, ``_LAYER_NSPLIT`` for K9d) are added in chunk order; a dynamic
hidden is quantized per row and per chunk, so the chunk count is part of
the result. The int8 kernels take the folded tree in every mode (dynamic,
"ln", "hidden", "full", each "+score") and the unfolded one (every scale
dynamic, the LN affines as operands), S <= 127: K9d and K9c on the dense
route, K9a on either route (the masked attention of the text tower and of
an odd head count, on bf16 or f32 rows; the mask-free one at S a multiple
of 16). Each launch off the folded dense route at S <= 64 is also counted
under its branch (``LAUNCHES["<kernel>/<branch>"]``, ``k9_branch``).

``run_fused_tower`` is the JAX function's int8 route: the dense route
(an even head count without a mask, S not a multiple of 16) or the
non-dense one (a mask, an odd head count, or S a multiple of 16), folded
or unfolded trees in any of their modes, ``cls_only`` or every row.
Under ``_FUSE`` = "halves" (the default) each layer is K3 + K4; under
"block" K9a on either route, under "layer" K9d and under "stream" one K9c
for every layer on the dense route; the non-dense route runs the halves
under "layer" and "stream", as the JAX package falls back. With
``cls_only`` the dense route's last layer runs as the reference's
``_CLS_ATTNQ = True`` route: K5, then the MLP half on the CLS rows, for S
<= 64; from 65 tokens on K3 on all rows, then K4 on the CLS rows. The
non-dense route runs every layer on every row, then takes the CLS rows.
``run_float_tower`` is its route without a quant tree, bf16 or f32,
causal (``encode_text``) or mask-free (the float vision towers): the
halves (K6a, K6b), or K9b per layer under "block" (bf16 or f32). The
knobs are read at call time.
"""

from __future__ import annotations

import math

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops.attention import ROUTES, attention_route, causal_mask
from jcf_tpu_torch.ops.bf16_gemm import (
    bf16_gemm_bias,
    bf16_gemm_gelu,
    bf16_gemm_residual,
    gelu_plain,
    matmul_plain,
)
from jcf_tpu_torch.ops.f32_gemm import (
    f32_gemm_bias,
    f32_gemm_gelu,
    f32_gemm_residual,
    need_planes,
    planes_key,
)
from jcf_tpu_torch.ops.int8_gemm import (
    dequant_plain,
    gelu_quant_plain,
    int8_gemm_bf16,
    int8_gemm_f32,
    int8_gemm_gelu_quant,
    int8_gemm_residual,
    int8_matmul_plain,
)
from jcf_tpu_torch.ops.layers import GELU_TANH_COEF, LN_EPS, layer_slice

# launches of this module's kernels (CUDA tensors only); the int8 row and
# attention kernels by variant: static scale, or dynamic (``*_rows``,
# ``*_f32``: the f32 context before its row quantization); the unfolded
# tree's (``ln_affine_quant_rows``, ``*_scaled``: the scores x 1/sqrt(d));
# f32 rows (``*_f32`` of the LN kernels); the masked attention of the
# int8 halves (``masked_attention``) and of the float halves
# (``causal_attention``, and ``head_attention`` without a mask); those on
# bf16 qkv and the mask-free attention of the int8 halves (``attention*``)
# also by route (``attention_route``) as "<name>/mma" or "<name>/rowloop"
LAUNCHES = {"ln_quant": 0, "ln_quant_rows": 0, "ln_quant_f32": 0, "ln_quant_rows_f32": 0,
            "ln_affine_quant_rows": 0, "ln_affine_quant_rows_f32": 0, "quant_rows": 0,
            "gelu_quant_rows": 0, "attention": 0, "attention_f32": 0, "attention_scaled": 0,
            "attention_scaled_f32": 0, "cls_attention": 0, "cls_attention_f32": 0,
            "cls_attention_scaled": 0, "cls_attention_scaled_f32": 0, "masked_attention": 0,
            "masked_attention_f32": 0, "ln_affine": 0, "ln_affine_f32": 0,
            "causal_attention": 0, "causal_attention_f32": 0, "head_attention": 0,
            "head_attention_f32": 0, "pair_attention_bf16": 0, "pair_attention_f32": 0,
            "block_int8": 0, "layer_fused_int8": 0, "stream_tower_int8": 0, "block_bf16": 0,
            "block_f32": 0}
MASKED_KERNELS = ("masked_attention", "masked_attention_f32", "causal_attention",
                  "head_attention")
PAIRED_KERNELS = ("attention", "attention_f32", "attention_scaled", "attention_scaled_f32")
LAUNCHES.update({f"{k}/{r}": 0 for k in MASKED_KERNELS + PAIRED_KERNELS for r in ROUTES})
# the LayerNorm rows off the vector kernel (``ln_affine``: a width not a
# multiple of 16 bytes, or a misaligned tensor; the LN + quant kernel: a
# width other than 512 or 768, or a misaligned tensor) also by that route
LN_QUANT_KERNELS = ("ln_quant", "ln_quant_rows", "ln_quant_f32", "ln_quant_rows_f32",
                    "ln_affine_quant_rows", "ln_affine_quant_rows_f32")
# the row quantization of f32 rows off the vector kernel (a width not a
# multiple of 4, or a misaligned tensor) by that route too
QUANT_ROWS_KERNELS = ("quant_rows", "gelu_quant_rows")
LAUNCHES.update({f"{k}/scalar": 0
                 for k in ("ln_affine", "ln_affine_f32") + LN_QUANT_KERNELS + QUANT_ROWS_KERNELS})
# the LN + quant kernel's vector instances
LN_QUANT_VEC_WIDTHS = (512, 768)
# the row quantization's widest row
QUANT_ROWS_MAX_N = 4096
# the float kernels' variants by dtype: the launch count's suffix and the
# C entries' f32 flag
_FLOAT = {torch.bfloat16: ("", 0), torch.float32: ("_f32", 1)}

# the dense int8 tower's sequence lengths: below 128 tokens (the attention
# kernel's keys), and the CLS-query attention up to 64 (one padded half)
MAX_SEQ = 127
CLS_MAX_SEQ = 64

# the towers' layer variant, the JAX package's knob of the same name:
# "halves" (K3 + K4, K6a + K6b), "block" (K9a, and K9b on the text tower),
# "layer" (K9d) or "stream" (K9c); read at call time
_FUSE = "halves"
FUSE_MODES = ("halves", "block", "layer", "stream")
# hidden chunks of the MLP in K9a and K9c, and in K9d
_MLP_NSPLIT = 1
_LAYER_NSPLIT = 4


# ---------------------------------------------------------------------------
# LayerNorm (z-norm, or with its affine) + int8 quant
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


def quant_rows_plain(x: torch.Tensor):
    """``_quant_rows``: dynamic per-row symmetric int8 of f32 rows x [M, N]
    -> (int8 [M, N], f32 scales [M]). ``amax = max(max |x|, 1e-8)``, then
    ``round(x * (127 / amax))`` (a reciprocal multiply, where
    ``ops.quant.quantize_rows`` divides) clipped to +-127, and the scale
    ``amax * f32(1/127)``."""
    amax = torch.clamp_min(x.abs().amax(dim=-1), 1e-8)
    inv = torch.full_like(amax, 127.0) / amax  # an IEEE division, as 127.0 / amax in JAX
    q = torch.clamp(torch.round(x * inv[:, None]), -127, 127).to(torch.int8)
    return q, amax * (1.0 / 127.0)


def ln_quant_rows_plain(x: torch.Tensor):
    """LN z-norm then ``quant_rows_plain`` (``_ln_norm`` + ``_quant_rows``)."""
    return quant_rows_plain(_z_rows(x))


def ln_affine_quant_rows_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """``_ln_rows`` then ``_quant_rows`` (the unfolded tree's K3 / K4 / K5
    head): the z-norm of bf16 or f32 rows x [M, E], then ``z * scale +
    bias`` with the affine in f32 (a product and a sum, each rounded),
    then ``quant_rows_plain`` -> (int8 [M, E], f32 row scales [M])."""
    return quant_rows_plain(_z_rows(x) * scale.float() + bias.float())


def gelu_quant_rows_plain(h: torch.Tensor):
    """QuickGELU (``_quick_gelu32``) then ``quant_rows_plain`` on the f32
    c_fc output."""
    return quant_rows_plain(gelu_plain(h))


def _scalar(name: str, t, device) -> None:
    if t is not None and (t.numel() != 1 or t.dtype != torch.float32 or t.device != device):
        raise ValueError(f"{name} must be a one-element f32 tensor on {device}")


def _ln_quant_launch(x: torch.Tensor, inv, affine=None):
    """The LN + quant kernel on rows x [M, E] (bf16 or f32): the z-norm
    with the static ``inv`` or per row, or, given ``affine`` (scale,
    bias [E]), the LN with its affine in f32, per row. Rows of width 512
    or 768 on 16-byte aligned tensors take the vector kernel; others the
    scalar kernel, which also counts ``LAUNCHES["<name>/scalar"]``."""
    m, e = x.shape
    if x.dtype not in _FLOAT or e > 1024:
        raise ValueError(f"ln_quant kernel takes bf16 or f32 rows with E <= 1024, got {x.dtype} "
                         f"E={e}")
    suffix, f32 = _FLOAT[x.dtype]
    _scalar("inv", inv, x.device)
    if affine is not None:
        if inv is not None:
            raise ValueError("the LN affine goes with dynamic row scales only")
        affine = [t.float().contiguous() for t in affine]
        if any(tuple(t.shape) != (e,) or t.device != x.device for t in affine):
            raise ValueError(f"the LN scale and bias must be ({e},) on {x.device}")
    x = x.contiguous()
    out = torch.empty((m, e), dtype=torch.int8, device=x.device)
    scale = torch.empty(m, dtype=torch.float32, device=x.device) if inv is None else None
    name = ("ln_affine_quant_rows" if affine is not None
            else "ln_quant" if inv is not None else "ln_quant_rows") + suffix
    g, b = affine if affine is not None else (None, None)
    aligned = (x, out) + (tuple(affine) if affine is not None else ())
    vec = e in LN_QUANT_VEC_WIDTHS and m > 0 and all(t.data_ptr() % 16 == 0 for t in aligned)
    lib = _build.load()
    err = lib.jcf_ln_quant(x.data_ptr(), *(t.data_ptr() if t is not None else None
                                           for t in (g, b, inv, out, scale)),
                           m, e, f32, int(vec), _build.stream_ptr(x.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    if not vec:
        LAUNCHES[name + "/scalar"] += 1
    return out, scale


def ln_quant(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """x [M, E] bf16 or f32, inv a one-element f32 tensor -> int8 [M, E]."""
    if not x.is_cuda:
        return ln_quant_plain(x, inv)
    return _ln_quant_launch(x, inv)[0]


def ln_quant_rows(x: torch.Tensor):
    """x [M, E] bf16 or f32 -> (int8 [M, E], f32 row scales [M]): the LN
    z-norm and a dynamic per-row quantization (the same kernel as
    ``ln_quant``, without a calibrated scale)."""
    if not x.is_cuda:
        return ln_quant_rows_plain(x)
    return _ln_quant_launch(x, None)


def ln_affine_quant_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """x [M, E] bf16 or f32, the LN scale and bias [E] (any float dtype,
    used in f32) -> (int8 [M, E], f32 row scales [M]): the LN with its
    affine and a dynamic per-row quantization (the same kernel)."""
    if not x.is_cuda:
        return ln_affine_quant_rows_plain(x, scale, bias)
    return _ln_quant_launch(x, None, (scale, bias))


def quant_rows_route(n: int, dtype: torch.dtype, aligned: bool) -> str:
    """The row quantization kernel's route for f32 rows of width ``n``
    (``aligned``: the input and output rows start on 16-byte boundaries)
    -> "vector" (a width that is a multiple of 4 on aligned rows) or
    "scalar"; raises ``ValueError`` for rows the kernel refuses (not f32,
    or N outside 1-4096)."""
    if dtype != torch.float32 or not 1 <= n <= QUANT_ROWS_MAX_N:
        raise ValueError(f"the row quantization kernel takes f32 rows [M, N <= "
                         f"{QUANT_ROWS_MAX_N}], got {dtype} N={n}")
    return "vector" if n % 4 == 0 and aligned else "scalar"


def quant_rows(x: torch.Tensor, *, gelu: bool = False):
    """Dynamic per-row int8 of f32 rows x [M, N] (N <= 4096) -> (int8
    [M, N], f32 row scales [M]); with ``gelu``, of QuickGELU(x) (K4's
    hidden without a static scale). Rows of a width that is a multiple of
    4 on 16-byte aligned tensors take the vector kernel; others the scalar
    kernel, which also counts ``LAUNCHES["<name>/scalar"]``
    (``quant_rows_route``). Both write the same bits."""
    if not x.is_cuda:
        return (gelu_quant_rows_plain if gelu else quant_rows_plain)(x)
    name = "gelu_quant_rows" if gelu else "quant_rows"
    if x.dim() != 2:
        raise ValueError(f"{name} kernel takes f32 rows [M, N], got {tuple(x.shape)}")
    m, n = x.shape
    x = x.contiguous()
    # the output is fresh, so aligned; the C entry checks it again
    vec = quant_rows_route(n, x.dtype, m > 0 and x.data_ptr() % 16 == 0) == "vector"
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    scale = torch.empty(m, dtype=torch.float32, device=x.device)
    lib = _build.load()
    err = lib.jcf_quant_rows(x.data_ptr(), out.data_ptr(), scale.data_ptr(), m, n, int(gelu),
                             int(vec), _build.stream_ptr(x.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    if not vec:
        LAUNCHES[name + "/scalar"] += 1
    return out, scale


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _score_scale(scale) -> str:
    """The launch-count tag of a score scale: none on the folded tree."""
    return "" if scale is None else "_scaled"


def attention_plain(qkv: torch.Tensor, ctx_inv, s: int, n_heads: int, shift=None, *,
                    scale=None, floor: float = 0.0) -> torch.Tensor:
    """Plain version of the attention kernel: qkv [B' * S, 3E] bf16 -> the
    context [B' * S, E]: int8 with the static ``ctx_inv`` folded into the
    normalizer, or, with ``ctx_inv`` None, f32 normalized by 1 / sum (the
    input of a dynamic row quantization). The scores q.k in f32, x
    ``scale`` where it is given (the unfolded tree's 1/sqrt(d); the folded
    tree's q carries it).

    The softmax shift is max(floor, max over the head PAIR's scores): the
    reference's paired TPU layout takes one max per pair over both heads
    and, on its dense route, the zeroed pad keys' 0 (``floor`` 0; its
    non-dense route at S a multiple of 16 has no pad keys: -inf). The
    shift cancels in real arithmetic, but it moves the bf16 rounding of
    p, so it is kept exactly. A calibrated ``shift`` (one-element f32, the
    tree's ``score_shift``) replaces it, with no max and no clamp."""
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    b = rows // s
    t = qkv.float().reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)  # [3, B, H, S, D]
    q, k, v = t[0], t[1], t[2]
    scores = torch.matmul(q, k.transpose(-1, -2))  # [B, H, S, S]
    if scale is not None:
        scores = scores * scale
    pair = scores.reshape(b, n_heads // 2, 2, s, s)
    if shift is None:
        m = pair.amax(dim=(2, 4), keepdim=True).clamp_min(floor)
    else:
        m = shift.reshape(())
    p = torch.exp(pair - m).to(torch.bfloat16).float().reshape(b, n_heads, s, s)
    ctx_u = torch.matmul(p, v)  # [B, H, S, D]
    sums = p.sum(dim=-1, keepdim=True)
    num = ctx_inv.reshape(()) if ctx_inv is not None else sums.new_ones(())
    ctx = (ctx_u * (num / torch.clamp_min(sums, 1e-30))).permute(0, 2, 1, 3).reshape(rows, e)
    if ctx_inv is None:
        return ctx
    return torch.clamp(torch.round(ctx), -127, 127).to(torch.int8)


def attention(qkv: torch.Tensor, ctx_inv, s: int, n_heads: int, shift=None, *, scale=None,
              floor: float = 0.0) -> torch.Tensor:
    """Attention wrapper: a CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. S <= 127, an even head count. Head dim 64 with 16-byte
    aligned qkv takes the tensor-core kernel, other head dims and
    alignments the CUDA-core row loop (``attention_route``; counted as
    "<name>/mma" or "<name>/rowloop")."""
    if not qkv.is_cuda:
        return attention_plain(qkv, ctx_inv, s, n_heads, shift, scale=scale, floor=floor)
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    if qkv.dtype != torch.bfloat16 or rows % s or n_heads % 2 or s > MAX_SEQ:
        raise ValueError(
            f"attention kernel takes bf16 qkv, S <= {MAX_SEQ} and an even head count; "
            f"got {qkv.dtype}, S={s}, H={n_heads}, D={d}"
        )
    _scalar("ctx_inv", ctx_inv, qkv.device)
    _scalar("shift", shift, qkv.device)
    qkv = qkv.contiguous()
    name = "attention" + _score_scale(scale) + ("" if ctx_inv is not None else "_f32")
    out = torch.empty((rows, e), dtype=torch.int8 if ctx_inv is not None else torch.float32,
                      device=qkv.device)
    route = attention_route(qkv.dtype, d, qkv.data_ptr(), out.data_ptr())
    lib = _build.load()
    err = lib.jcf_attention(qkv.data_ptr(), ctx_inv.data_ptr() if ctx_inv is not None else None,
                            shift.data_ptr() if shift is not None else None, out.data_ptr(),
                            rows // s, s, n_heads, d, 1.0 if scale is None else scale,
                            int(scale is not None), floor, int(ctx_inv is None),
                            int(route == "mma"), _build.stream_ptr(qkv.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}/{route}"] += 1
    return out


def cls_attention_plain(q: torch.Tensor, kv: torch.Tensor, ctx_inv, s: int, n_heads: int,
                        shift=None, *, scale=None) -> torch.Tensor:
    """Plain version of the CLS-query attention kernel (K5): q [B', E]
    bf16 CLS queries, kv [B' * S, 2E] bf16 keys and values of all rows ->
    the context [B', E], int8 with the static ``ctx_inv`` folded into the
    normalizer, or f32 with ``ctx_inv`` None. The scores q.k in f32, x
    ``scale`` where it is given (the unfolded tree; the folded q carries
    1/sqrt(d)).

    The shift is the max over the head pair's scores and, when S < 64,
    the zero-padded keys' 0 (``_attn_cls_int8_kernel`` pads each head to
    64 keys); or the calibrated ``shift``. PV takes bf16 p, the normalizer
    sums the f32 p."""
    b, e = q.shape
    d = e // n_heads
    k, v = kv.float().reshape(b, s, 2, n_heads, d).permute(2, 0, 3, 1, 4)  # [B, H, S, D]
    scores = torch.matmul(q.float().reshape(b, n_heads, 1, d), k.transpose(-1, -2))
    if scale is not None:
        scores = scores * scale
    pair = scores.reshape(b, n_heads // 2, 2, 1, s)
    if shift is not None:
        m = shift.reshape(())
    else:
        m = pair.amax(dim=(2, 4), keepdim=True)
        if s < CLS_MAX_SEQ:
            m = m.clamp_min(0.0)
    p = torch.exp(pair - m).reshape(b, n_heads, 1, s)
    ctx_u = torch.matmul(p.to(torch.bfloat16).float(), v)  # [B, H, 1, D]
    sums = p.sum(dim=-1, keepdim=True)
    num = ctx_inv.reshape(()) if ctx_inv is not None else sums.new_ones(())
    ctx = (ctx_u * (num / torch.clamp_min(sums, 1e-30))).reshape(b, e)
    if ctx_inv is None:
        return ctx
    return torch.clamp(torch.round(ctx), -127, 127).to(torch.int8)


def cls_attention(q: torch.Tensor, kv: torch.Tensor, ctx_inv, s: int, n_heads: int,
                  shift=None, *, scale=None) -> torch.Tensor:
    """CLS-query attention wrapper: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not q.is_cuda:
        return cls_attention_plain(q, kv, ctx_inv, s, n_heads, shift, scale=scale)
    b, e = q.shape
    if (q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16 or e != 64 * n_heads
            or n_heads % 2 or s > CLS_MAX_SEQ or tuple(kv.shape) != (b * s, 2 * e)):
        raise ValueError(f"cls_attention kernel takes bf16 q [B, E] and kv [B * S, 2E] with "
                         f"head dim 64, an even head count and S <= {CLS_MAX_SEQ}; got q "
                         f"{q.dtype} {tuple(q.shape)}, kv {kv.dtype} {tuple(kv.shape)}, S={s}, "
                         f"H={n_heads}")
    _scalar("ctx_inv", ctx_inv, q.device)
    _scalar("shift", shift, q.device)
    q, kv = q.contiguous(), kv.contiguous()
    name = "cls_attention" + _score_scale(scale) + ("" if ctx_inv is not None else "_f32")
    out = torch.empty((b, e), dtype=torch.int8 if ctx_inv is not None else torch.float32,
                      device=q.device)
    lib = _build.load()
    err = lib.jcf_cls_attention(q.data_ptr(), kv.data_ptr(),
                                ctx_inv.data_ptr() if ctx_inv is not None else None,
                                shift.data_ptr() if shift is not None else None, out.data_ptr(),
                                b, s, n_heads, 1.0 if scale is None else scale,
                                int(scale is not None), int(ctx_inv is None),
                                _build.stream_ptr(q.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# LayerNorm with its affine, and causal attention (the bf16 text halves)
# ---------------------------------------------------------------------------


def ln_affine_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``_ln_rows``: f32 statistics and affine on bf16 or f32 rows with the
    LN scale and bias already cast to the rows' dtype -> that dtype."""
    return (_z_rows(x) * scale.float() + bias.float()).to(x.dtype)


def _float_kind(name: str, x: torch.Tensor):
    """(launch-count suffix, f32 flag) of a float kernel for x's dtype."""
    if x.dtype not in _FLOAT:
        raise ValueError(f"{name} kernel takes bf16 or f32, got {x.dtype}")
    return _FLOAT[x.dtype]


def ln_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [M, E] bf16 or f32, scale and bias [E] in x's dtype -> [M, E] in
    x's dtype. Rows of a width that is a multiple of 16 bytes, on 16-byte
    aligned tensors, take the vector kernel; others the scalar kernel,
    which also counts ``LAUNCHES["ln_affine<suffix>/scalar"]``."""
    if not x.is_cuda:
        return ln_affine_plain(x, scale, bias)
    m, e = x.shape
    suffix, f32 = _float_kind("ln_affine", x)
    if e > 1024:
        raise ValueError(f"ln_affine kernel takes rows with E <= 1024, got E={e}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != x.dtype or tuple(t.shape) != (e,) or t.device != x.device:
            raise ValueError(f"{name} must be {x.dtype} ({e},) on the rows' device")
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    lib = _build.load()
    ptrs = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr())
    vec = (e * x.element_size()) % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    err = lib.jcf_ln_affine(*ptrs, m, e, f32, int(vec), _build.stream_ptr(x.device))
    name = "ln_affine" + suffix
    _build.check(err, name)
    LAUNCHES[name] += 1
    if not vec:
        LAUNCHES[name + "/scalar"] += 1
    return out


def causal_attention_plain(qkv: torch.Tensor, s: int, n_heads: int) -> torch.Tensor:
    """Plain version of the causal attention of the float halves
    (``_paired_attention`` with the additive causal mask, per head): qkv
    [B * S, 3E] bf16 or f32 -> context [B * S, E] in qkv's dtype."""
    return bias_attention_plain(qkv, s, n_heads, causal_mask(s, qkv.device))


def _head_attention_plain(qkv: torch.Tensor, s: int, n_heads: int, bias, scale) -> torch.Tensor:
    """Per-head softmax attention with an optional additive [S, S] f32
    bias -> the f32 context [B * S, E]: f32 scores (x ``scale`` where it
    is given), the bias, a per-head max, exp and sum in f32, p / sum in
    f32, then p in qkv's dtype for PV with f32 sums."""
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    b = rows // s
    q, k, v = qkv.float().reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)  # [B, H, S, D]
    scores = torch.matmul(q, k.transpose(-1, -2))
    if scale is not None:
        scores = scores * scale
    if bias is not None:
        scores = scores + bias
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(p.to(qkv.dtype).float(), v)  # [B, H, S, D]
    return ctx.permute(0, 2, 1, 3).reshape(rows, e)


def bias_attention_plain(qkv: torch.Tensor, s: int, n_heads: int, bias: torch.Tensor) -> torch.Tensor:
    """``_paired_attention`` per head with an additive [S, S] f32 bias:
    qkv [B * S, 3E] bf16 or f32 -> context [B * S, E] in qkv's dtype,
    the scores x 1/sqrt(d)."""
    d = qkv.shape[1] // 3 // n_heads
    return _head_attention_plain(qkv, s, n_heads, bias, 1.0 / math.sqrt(d)).to(qkv.dtype)


def masked_attention_plain(qkv: torch.Tensor, s: int, n_heads: int, *, causal: bool, scale=None,
                           ctx_inv=None, f32_ctx: bool = False) -> torch.Tensor:
    """Plain version of the masked attention kernel (``_batched_attention``
    with ``use_mask=True``: ``_paired_attention``, or the per-head loop of
    an odd head count): qkv [B * S, 3E] bf16 or f32, the causal mask or
    none (the reference's bias is 0 on real keys; its pad keys carry
    -1e30 and contribute exact zeros, so the port does not pad), the
    scores x ``scale`` where it is given -> the context [B * S, E] in
    qkv's dtype (the float halves), in f32 (``f32_ctx``: the int8 halves'
    dynamic context), or ``int8(round(ctx * ctx_inv))`` (a static
    context scale, post-multiplied)."""
    bias = causal_mask(s, qkv.device) if causal else None
    ctx = _head_attention_plain(qkv, s, n_heads, bias, scale)
    if ctx_inv is not None:
        return torch.clamp(torch.round(ctx * ctx_inv.reshape(())), -127, 127).to(torch.int8)
    return ctx if f32_ctx else ctx.to(qkv.dtype)


def masked_attention(qkv: torch.Tensor, s: int, n_heads: int, *, causal: bool, scale=None,
                     ctx_inv=None, f32_ctx: bool = False) -> torch.Tensor:
    """Masked attention wrapper: a CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. S <= 128, any head count, a head dim
    divisible by 8 (f32 qkv: 64); the f32 and int8 contexts from bf16 qkv
    only. bf16 qkv at head dim 64 takes the tensor-core kernel, other head
    dims the CUDA-core row loop (``attention_route``; counted as
    "<name>/mma" or "<name>/rowloop"); f32 qkv the register-tiled kernel
    (``causal_attention_f32``, ``head_attention_f32``: one route)."""
    if not qkv.is_cuda:
        return masked_attention_plain(qkv, s, n_heads, causal=causal, scale=scale,
                                      ctx_inv=ctx_inv, f32_ctx=f32_ctx)
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    suffix, f32 = _float_kind("masked attention", qkv)
    int8_path = ctx_inv is not None or f32_ctx
    if rows % s or s > 128 or d % 8 or e != d * n_heads or (f32 and (int8_path or d != 64)):
        raise ValueError(f"masked attention kernel takes S <= 128, a head dim divisible by 8 "
                         f"(64 for f32 qkv), and bf16 qkv for an f32 or int8 context; got "
                         f"{qkv.dtype}, rows={rows}, S={s}, H={n_heads}, D={d}")
    _scalar("ctx_inv", ctx_inv, qkv.device)
    if int8_path:
        name, out_kind = ("masked_attention", 2) if ctx_inv is not None else ("masked_attention_f32", 1)
        out_dtype = torch.int8 if ctx_inv is not None else torch.float32
    else:
        name, out_kind = ("causal_attention" if causal else "head_attention") + suffix, 0
        out_dtype = qkv.dtype
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:
        raise ValueError(f"masked attention kernel loads 16-byte aligned rows; qkv is "
                         f"{qkv.data_ptr() % 16} bytes off")
    out = torch.empty((rows, e), dtype=out_dtype, device=qkv.device)
    route = None if f32 else attention_route(qkv.dtype, d, qkv.data_ptr(), out.data_ptr())
    lib = _build.load()
    err = lib.jcf_masked_attention(qkv.data_ptr(), ctx_inv.data_ptr() if ctx_inv is not None else None,
                                   out.data_ptr(), rows // s, s, n_heads, d,
                                   1.0 if scale is None else scale, int(causal),
                                   int(scale is not None), f32, out_kind, int(route == "mma"),
                                   _build.stream_ptr(qkv.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    if route is not None:
        LAUNCHES[f"{name}/{route}"] += 1
    return out


def causal_attention(qkv: torch.Tensor, s: int, n_heads: int) -> torch.Tensor:
    """Causal attention of the float halves (bf16 or f32, the scores x
    1/sqrt(d)): the masked attention kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not qkv.is_cuda:
        return causal_attention_plain(qkv, s, n_heads)
    d = qkv.shape[1] // 3 // n_heads
    return masked_attention(qkv, s, n_heads, causal=True, scale=1.0 / math.sqrt(d))


def _pad_floor(s: int) -> float:
    """The pair shift's floor: 0 where the reference pads the keys to a
    multiple of 8 (its zeroed pad keys score 0), none where S is one."""
    return 0.0 if s % 8 else -math.inf


def pair_attention_plain(qkv: torch.Tensor, s: int, n_heads: int) -> torch.Tensor:
    """Plain version of the mask-free attention kernel of the float towers
    (``_paired_attention_nomask``, unfolded, no shift or post scale): qkv
    [B' * S, 3E] bf16 or f32 -> the context [B' * S, E] in qkv's dtype.
    Scores q.k in f32, then x 1/sqrt(d); one shift per head PAIR, the max
    over both heads' keys, floored at 0 where S is not a multiple of 8; p
    = exp(s - m) rounded to qkv's dtype; PV and the normalizer on that p in
    f32; ctx_u * (1 / max(l, 1e-30))."""
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    b = rows // s
    dt = qkv.dtype
    q, k, v = qkv.float().reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)  # [B, H, S, D]
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    pair = scores.reshape(b, n_heads // 2, 2, s, s)
    m = pair.amax(dim=(2, 4), keepdim=True).clamp_min(_pad_floor(s))
    p = torch.exp(pair - m).to(dt).float().reshape(b, n_heads, s, s)
    ctx_u = torch.matmul(p, v)
    ctx = ctx_u * (1.0 / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30))
    return ctx.to(dt).permute(0, 2, 1, 3).reshape(rows, e)


def pair_attention(qkv: torch.Tensor, s: int, n_heads: int) -> torch.Tensor:
    """Mask-free attention wrapper (bf16 or f32, S <= 127, an even head
    count, head dim 64 with 16-byte aligned rows): the CUDA kernel for CUDA
    tensors (bf16 on the tensor cores, f32 register-tiled on the CUDA
    cores), the plain version for CPU tensors."""
    if not qkv.is_cuda:
        return pair_attention_plain(qkv, s, n_heads)
    rows, e3 = qkv.shape
    e = e3 // 3
    d = e // n_heads
    if qkv.dtype not in _FLOAT:
        raise ValueError(f"pair attention kernel takes bf16 or f32, got {qkv.dtype}")
    if rows % s or s > MAX_SEQ or n_heads % 2 or e != d * n_heads:
        raise ValueError(f"pair attention kernel takes S <= {MAX_SEQ} and an even head count; "
                         f"got rows={rows}, S={s}, H={n_heads}, D={d}")
    f32 = _FLOAT[qkv.dtype][1]
    name = "pair_attention_f32" if f32 else "pair_attention_bf16"
    qkv = qkv.contiguous()
    if d != 64 or qkv.data_ptr() % 16:
        raise ValueError(f"pair attention kernel takes head dim 64 with 16-byte aligned rows; "
                         f"got D={d}, offset {qkv.data_ptr() % 16} bytes")
    out = torch.empty((rows, e), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load()
    err = lib.jcf_pair_attention(qkv.data_ptr(), out.data_ptr(), rows // s, s, n_heads, d,
                                 1.0 / math.sqrt(d), _pad_floor(s), f32,
                                 _build.stream_ptr(qkv.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# the halves and the tower
# ---------------------------------------------------------------------------


def _ln_quant_any(x: torch.Tensor, inv, ln=None):
    """The head of K3 / K4 / K5 -> (int8, row scales or None): the LN
    z-norm with the static scale ``inv`` or per row (the folded tree), or
    with ``ln`` ({"scale", "bias"}: the unfolded tree's LN affine) the LN
    with its affine, per row."""
    if ln is not None:
        if inv is not None:
            raise ValueError("the unfolded tree (an LN affine) carries no static scales")
        return ln_affine_quant_rows(x, ln["scale"], ln["bias"])
    return (ln_quant(x, inv), None) if inv is not None else ln_quant_rows(x)


def _context(ctx: torch.Tensor, ctx_inv):
    """The attention kernel's output as the out-proj's int8 input: int8
    already (static ``ctx_inv``), or the f32 context quantized per row."""
    return (ctx, None) if ctx_inv is not None else quant_rows(ctx)


def _unfolded_scale(ln, e: int, n_heads: int):
    """The score scale of the int8 attention: 1/sqrt(d) on the unfolded
    tree (``ln`` given), none on the folded tree (its q carries it)."""
    return None if ln is None else 1.0 / math.sqrt(e // n_heads)


def attn_half_int8(x: torch.Tensor, attn: dict, s: int, n_heads: int, *, ln=None,
                   causal: bool = False, dense: bool = True) -> torch.Tensor:
    """K3 on rows x [B' * S, E] (bf16 or f32) with one layer's attention
    weights -> x + attention(x) in x's dtype. The folded tree (``ln``
    None) with static or dynamic LN and context scales and an optional
    calibrated shift, as the layer's tree carries them; or the unfolded
    tree with ``ln`` (the layer's ``ln_1`` affine in x's dtype, as
    ``_halves_block`` casts it), every scale dynamic, the scores x
    1/sqrt(d).

    The attention: ``causal`` or an odd head count takes the reference's
    masked route (``use_mask=True``, no shift); else the mask-free paired
    attention, its shift floored at 0 on the ``dense`` route (zeroed pad
    keys) and not at all off it (S a multiple of 16)."""
    x_q, x_sc = _ln_quant_any(x, attn.get("ln_inv"), ln)
    wq = attn["w_qkv"]
    qkv = int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias, row_scale=x_sc)
    ctx_inv = attn.get("ctx_inv")
    scale = _unfolded_scale(ln, x.shape[1], n_heads)
    if causal or n_heads % 2:
        ctx = masked_attention(qkv, s, n_heads, causal=causal, scale=scale, ctx_inv=ctx_inv,
                               f32_ctx=ctx_inv is None)
    else:
        ctx = attention(qkv, ctx_inv, s, n_heads, attn.get("score_shift"), scale=scale,
                        floor=0.0 if dense else -math.inf)
    c_q, c_sc = _context(ctx, ctx_inv)
    wo = attn["w_out"]
    return int8_gemm_residual(c_q, wo.w_int8, wo.w_scale, wo.bias, x, row_scale=c_sc)


def mlp_half_int8(x: torch.Tensor, mlp: dict, *, ln=None, nsp: int | None = None) -> torch.Tensor:
    """K4 on rows x [M, E] (bf16 or f32) with one layer's MLP weights -> x
    + mlp(x) in x's dtype; ``ln`` the unfolded tree's ``ln_2`` affine (in
    x's dtype for the halves, the layer params' own for the CLS rows, as
    ``_mlp_half_cls_rows`` takes it). A static hidden scale h_inv folds
    into the c_fc dequant scale and bias (``_fold_h_static``), so the GEMM
    lands in the quantized domain and QuickGELU runs there; without one
    the c_fc GEMM writes the f32 hidden and QuickGELU and the row
    quantization follow in one row kernel.

    The hidden width goes in ``nsp`` chunks (default ``_MLP_NSPLIT``, as
    ``_mlp_half_int8_kernel`` reads it; the CLS rows' ``_mlp_half_cls_rows``
    takes one): a dynamic hidden is quantized per row and per chunk, and
    c_proj's f32 partials, one a chunk, are added in chunk order before
    the bias and the residual. One chunk is one residual GEMM."""
    fc, pr = mlp["c_fc"], mlp["c_proj"]
    nsp = _chunks(_MLP_NSPLIT if nsp is None else nsp, fc.w_int8.shape[0])
    x_q, x_sc = _ln_quant_any(x, mlp.get("ln_inv"), ln)
    if "h_inv" in mlp:
        h_inv = mlp["h_inv"].reshape(())
        gelu_c = GELU_TANH_COEF / h_inv
        h_q, h_sc = int8_gemm_gelu_quant(x_q, fc.w_int8, fc.w_scale * h_inv, fc.bias * h_inv,
                                         gelu_c), None
    else:
        hidden = int8_gemm_f32(x_q, fc.w_int8, fc.w_scale, fc.bias, row_scale=x_sc)
        # a row of each chunk is a row of the [M * nsp, F / nsp] view
        m, f = hidden.shape
        h_q, h_sc = quant_rows(hidden.view(m * nsp, f // nsp), gelu=True)
        h_q, h_sc = h_q.view(m, f), h_sc.view(m, nsp) if nsp > 1 else h_sc
    if nsp == 1:
        return int8_gemm_residual(h_q, pr.w_int8, pr.w_scale, pr.bias, x, row_scale=h_sc)
    hs, zero, acc = h_q.shape[1] // nsp, torch.zeros_like(pr.bias), None
    for c in range(nsp):
        sl = slice(c * hs, (c + 1) * hs)
        part = int8_gemm_f32(h_q[:, sl].contiguous(), pr.w_int8[:, sl].contiguous(), pr.w_scale,
                             zero, row_scale=None if h_sc is None else h_sc[:, c].contiguous())
        acc = part if acc is None else acc + part
    return (x.float() + (acc + pr.bias)).to(x.dtype)


def attn_cls_int8(x: torch.Tensor, attn: dict, s: int, n_heads: int, *, ln=None) -> torch.Tensor:
    """K5 on dense rows x [B' * S, E] (S <= 64) with the last layer's
    attention weights -> the CLS rows of x + attention(x), [B', E] in x's
    dtype (``_attn_cls_int8_kernel``). LN and quant run on all rows, K/V
    (rows e:3e of w_qkv) on all rows, Q (rows :e) on the CLS rows only,
    with the CLS rows' scales where they are dynamic. ``ln`` as in
    ``attn_half_int8`` (the unfolded tree: LN affine, scores x
    1/sqrt(d))."""
    e = x.shape[1]
    x_q, x_sc = _ln_quant_any(x, attn.get("ln_inv"), ln)
    wq = attn["w_qkv"]
    kv = int8_gemm_bf16(x_q, wq.w_int8[e:], wq.w_scale[e:], wq.bias[e:], row_scale=x_sc)
    q = int8_gemm_bf16(x_q[::s].contiguous(), wq.w_int8[:e], wq.w_scale[:e], wq.bias[:e],
                       row_scale=x_sc[::s].contiguous() if x_sc is not None else None)
    ctx_inv = attn.get("ctx_inv")
    ctx = cls_attention(q, kv, ctx_inv, s, n_heads, attn.get("score_shift"),
                        scale=_unfolded_scale(ln, e, n_heads))
    c_q, c_sc = _context(ctx, ctx_inv)
    wo = attn["w_out"]
    return int8_gemm_residual(c_q, wo.w_int8, wo.w_scale, wo.bias, x[::s].contiguous(),
                              row_scale=c_sc)


# the float halves' GEMMs by dtype: (bias, QuickGELU, residual) epilogues
_GEMMS = {torch.bfloat16: (bf16_gemm_bias, bf16_gemm_gelu, bf16_gemm_residual),
          torch.float32: (f32_gemm_bias, f32_gemm_gelu, f32_gemm_residual)}


def _gemms(dt: torch.dtype):
    if dt not in _GEMMS:
        raise ValueError(f"the float tower halves take bf16 or f32 rows, got {dt}")
    return _GEMMS[dt]


def _planes(owner: dict, name: str, dt: torch.dtype) -> dict:
    """The f32 GEMMs' ``planes=`` argument: weight ``name``'s TF32 planes
    from its dict (``with_tf32_planes``), None where the tree has none;
    nothing for bf16 rows."""
    return {"planes": owner.get(planes_key(name))} if dt == torch.float32 else {}


def attn_half(x: torch.Tensor, layer: dict, s: int, n_heads: int, *,
              causal: bool = True) -> torch.Tensor:
    """K6a on rows x [B * S, E] (S rows per sequence), bf16 or f32, with
    one layer's float block params -> x + attention(LN1(x)) in x's dtype:
    causal (the text tower), or mask-free: over head pairs (the float
    vision towers), per head for an odd head count (the reference's
    ``use_mask=True`` route with a zero bias). Weights and the LN affine
    are cast to x's dtype, biases kept f32 (``_halves_block``). f32 rows
    on the card read the weights' TF32 planes from the layer
    (``ops.f32_gemm.with_tf32_planes``) and raise without them."""
    dt = x.dtype
    gemm_bias, _, gemm_residual = _gemms(dt)
    ln, attn = layer["ln_1"], layer["attn"]
    h = ln_affine(x, ln["scale"].to(dt), ln["bias"].to(dt))
    qkv = gemm_bias(h, attn["w_qkv"].to(dt), attn["b_qkv"].float(), **_planes(attn, "w_qkv", dt))
    if causal:
        ctx = causal_attention(qkv, s, n_heads)
    elif n_heads % 2:
        # the reference's per-head masked route (use_mask=True), a zero bias
        ctx = masked_attention(qkv, s, n_heads, causal=False,
                               scale=1.0 / math.sqrt(x.shape[1] // n_heads))
    else:
        ctx = pair_attention(qkv, s, n_heads)
    return gemm_residual(ctx, attn["w_out"].to(dt), attn["b_out"].float(), x,
                         **_planes(attn, "w_out", dt))


def mlp_half(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """K6b on rows x [M, E], bf16 or f32 -> x + c_proj(QuickGELU(c_fc(LN2(x))))
    in x's dtype."""
    dt = x.dtype
    _, gemm_gelu, gemm_residual = _gemms(dt)
    ln, mlp = layer["ln_2"], layer["mlp"]
    h = ln_affine(x, ln["scale"].to(dt), ln["bias"].to(dt))
    fc, proj = mlp["c_fc"], mlp["c_proj"]
    hidden = gemm_gelu(h, fc["w"].to(dt), fc["b"].float(), **_planes(fc, "w", dt))
    return gemm_residual(hidden, proj["w"].to(dt), proj["b"].float(), x, **_planes(proj, "w", dt))


# ---------------------------------------------------------------------------
# whole layers in one kernel (K9a-d)
# ---------------------------------------------------------------------------

# the options of the reference's int8 kernels, one bit each (as
# csrc/block_int8.cu numbers them); the kernel takes every set that
# ``run_fused_tower``'s routes give
FLAG_FOLDED, FLAG_STATIC_ACT, FLAG_STATIC_CTX, FLAG_STATIC_H = 1, 2, 4, 8
FLAG_STATIC_SHIFT, FLAG_DENSE, FLAG_USE_MASK = 16, 32, 64
# the port's own: the masked route's causal mask, f32 rows
FLAG_CAUSAL, FLAG_F32_ROWS = 128, 256
SERVING_FLAGS = FLAG_FOLDED | FLAG_STATIC_ACT | FLAG_STATIC_CTX | FLAG_STATIC_H | FLAG_DENSE


def _chunks(n: int, hidden: int) -> int:
    """The MLP's hidden chunk count: n where it divides the hidden width,
    else 1, as the reference falls back."""
    return n if hidden % n == 0 else 1


def quant_flags(tree: dict, *, dense: bool = True, use_mask: bool = False) -> int:
    """The reference kernels' options that an int8 tree (one layer or
    stacked) selects on a route: the dense row stream and the masked
    attention as the route takes them (``run_fused_tower`` decides both),
    folded where the tree says so (``quant_folded``), static scales where
    it carries them, a static softmax shift where it carries
    ``score_shift``."""
    attn, mlp = tree["attn"], tree["mlp"]
    flags = (FLAG_DENSE if dense else 0) | (FLAG_USE_MASK if use_mask else 0)
    if tree.get("quant_folded", False):
        flags |= FLAG_FOLDED
    if "ln_inv" in attn and "ln_inv" in mlp:
        flags |= FLAG_STATIC_ACT
    if "ctx_inv" in attn:
        flags |= FLAG_STATIC_CTX
    if "h_inv" in mlp:
        flags |= FLAG_STATIC_H
    if "score_shift" in attn:
        flags |= FLAG_STATIC_SHIFT
    return flags


def _ln_quant_plain_any(x: torch.Tensor, inv, ln=None):
    """The plain head of a K9 quantization -> (int8, row scales or None):
    LN z-norm + int8 with the static ``inv`` (row scales None) or per row
    (``_quant_rows_static`` or ``_quant_rows`` of ``_ln_norm``), or with
    ``ln`` (the unfolded tree's affine in the rows' dtype) ``_ln_rows`` then
    ``_quant_rows``."""
    if ln is not None:
        if inv is not None:
            raise ValueError("the unfolded tree (an LN affine) carries no static scales")
        return ln_affine_quant_rows_plain(x, ln["scale"], ln["bias"])
    return (ln_quant_plain(x, inv), None) if inv is not None else ln_quant_rows_plain(x)


def _attn_mid_plain(x: torch.Tensor, attn: dict, s: int, n_heads: int, *, ln=None,
                    causal: bool = False, dense: bool = True) -> torch.Tensor:
    """K3's math up to its residual add, unrounded: x + out-proj(int8
    attention(LN1 x)) in f32, each quantization static where the tree has
    its scale, else per row; ``ln`` the unfolded tree's LN affine (the
    scores then x 1/sqrt(d)). The attention as ``attn_half_int8`` takes it:
    masked (``causal``, or an odd head count: per head, the static context
    scale post-multiplied, no shift), or mask-free with the pair shift
    max(0, pair max) on the ``dense`` route, the pair max off it, or the
    tree's ``score_shift``."""
    x_q, x_sc = _ln_quant_plain_any(x, attn.get("ln_inv"), ln)
    wq, wo = attn["w_qkv"], attn["w_out"]
    qkv = dequant_plain(int8_matmul_plain(x_q, wq.w_int8), wq.w_scale, wq.bias,
                        x_sc).to(torch.bfloat16)
    ctx_inv = attn.get("ctx_inv")
    scale = _unfolded_scale(ln, x.shape[1], n_heads)
    if causal or n_heads % 2:
        ctx = masked_attention_plain(qkv, s, n_heads, causal=causal, scale=scale, ctx_inv=ctx_inv,
                                     f32_ctx=ctx_inv is None)
    else:
        ctx = attention_plain(qkv, ctx_inv, s, n_heads, attn.get("score_shift"), scale=scale,
                              floor=0.0 if dense else -math.inf)
    c_q, c_sc = (ctx, None) if ctx_inv is not None else quant_rows_plain(ctx)
    return x.float() + dequant_plain(int8_matmul_plain(c_q, wo.w_int8), wo.w_scale, wo.bias, c_sc)


def _mlp_proj_plain(mid: torch.Tensor, mlp: dict, nsp: int, *, ln=None) -> torch.Tensor:
    """K4's math before its residual add: c_proj(GELU-quant(c_fc(LN2
    mid))) + b_proj in f32 (``ln`` the unfolded tree's LN affine), the
    hidden in ``nsp`` chunks: each chunk's product an exact int32 sum, its
    f32 partial (x the c_proj scale, x the chunk's row scales where the
    hidden is dynamic) added in chunk order. A static hidden scale folds
    into c_fc (``_gelu_quant_static``); a dynamic one quantizes each chunk
    of each row on its own (``_quant_rows`` of the chunk's QuickGELU), so
    the chunk count changes the result."""
    fc, pr = mlp["c_fc"], mlp["c_proj"]
    x_q, x_sc = _ln_quant_plain_any(mid, mlp.get("ln_inv"), ln)
    if "h_inv" in mlp:
        h_inv = mlp["h_inv"].reshape(())
        fc_sc, fc_b, gelu_c = fc.w_scale * h_inv, fc.bias * h_inv, GELU_TANH_COEF / h_inv
    else:
        fc_sc, fc_b = fc.w_scale, fc.bias
    hs = fc.w_int8.shape[0] // nsp
    acc = None
    for c in range(nsp):
        sl = slice(c * hs, (c + 1) * hs)
        h = dequant_plain(int8_matmul_plain(x_q, fc.w_int8[sl]), fc_sc[sl], fc_b[sl], x_sc)
        h_q, h_sc = ((gelu_quant_plain(h, gelu_c), None) if "h_inv" in mlp
                     else gelu_quant_rows_plain(h))
        part = int8_matmul_plain(h_q, pr.w_int8[:, sl]).float() * pr.w_scale
        if h_sc is not None:
            part = part * h_sc[:, None]
        acc = part if acc is None else acc + part
    return acc + pr.bias


def _bf16_mid_layer_plain(x, layer, s, n_heads, nsp, lns):
    """One int8 layer on the dense route with its mid rounded to bf16, as
    the halves and K9c/K9d round it."""
    mid = _attn_mid_plain(x, layer["attn"], s, n_heads, ln=lns[0]).to(torch.bfloat16)
    return (mid.float() + _mlp_proj_plain(mid, layer["mlp"], nsp, ln=lns[1])).to(torch.bfloat16)


def _hidden(tree: dict) -> int:
    return tree["mlp"]["c_fc"].w_int8.shape[-2]


def _check_k9(name: str, tree: dict, n_heads: int, lns, *, causal: bool = False,
              dense: bool = True) -> None:
    """The route and tree a K9 kernel takes, as ``run_fused_tower`` picks
    them: the LN affines ``lns`` exactly when the tree is unfolded; the
    dense route only without a mask and with an even head count."""
    folded = tree.get("quant_folded", False)
    if folded != (lns[0] is None and lns[1] is None) or (not folded and None in lns):
        raise ValueError(f"{name}: an unfolded tree takes its (ln_1, ln_2) affines as lns, a folded "
                         f"one none; got a {'folded' if folded else 'unfolded'} tree and lns "
                         f"{'given' if lns[0] is not None else 'None'}")
    if dense and (causal or n_heads % 2):
        raise ValueError(f"{name}: the dense route takes no mask and an even head count; got "
                         f"causal={causal}, {n_heads} heads")


def block_int8_plain(x: torch.Tensor, layer: dict, s: int, n_heads: int, *, lns=(None, None),
                     causal: bool = False, dense: bool = True) -> torch.Tensor:
    """Plain version of K9a: one int8 layer of the folded tree (any mode)
    or of the unfolded one (``lns``: its (ln_1, ln_2) affines in x's
    dtype), on either route (``causal``, an odd head count, ``dense``, as
    ``attn_half_int8`` takes them), with the mid kept in f32 and the MLP in
    ``_MLP_NSPLIT`` chunks -> x's dtype (bf16, or f32 rows)."""
    mid = _attn_mid_plain(x, layer["attn"], s, n_heads, ln=lns[0], causal=causal, dense=dense)
    nsp = _chunks(_MLP_NSPLIT, _hidden(layer))
    return (mid + _mlp_proj_plain(mid, layer["mlp"], nsp, ln=lns[1])).to(x.dtype)


def layer_fused_int8_plain(x: torch.Tensor, layer: dict, s: int, n_heads: int, *,
                           lns=(None, None)) -> torch.Tensor:
    """Plain version of K9d: one int8 layer on the dense route, bf16 mid,
    the MLP in ``_LAYER_NSPLIT`` chunks; ``lns`` as in ``block_int8_plain``."""
    return _bf16_mid_layer_plain(x, layer, s, n_heads, _chunks(_LAYER_NSPLIT, _hidden(layer)), lns)


def _lns_slice(lns, i: int):
    """Layer i's (ln_1, ln_2) affines of stacked ones (None kept)."""
    return tuple(None if ln is None else {k: t[i] for k, t in ln.items()} for ln in lns)


def stream_tower_int8_plain(x: torch.Tensor, quant: dict, n_heads: int, *, s: int,
                            lns=(None, None)) -> torch.Tensor:
    """Plain version of K9c: every layer of the stacked tree on every row of
    the dense route, bf16 mid, the MLP in ``_MLP_NSPLIT`` chunks; ``lns``
    the unfolded tree's stacked [L, E] affines in x's dtype."""
    nsp = _chunks(_MLP_NSPLIT, _hidden(quant))
    for i in range(quant["attn"]["w_qkv"].w_int8.shape[0]):
        x = _bf16_mid_layer_plain(x, layer_slice(quant, i), s, n_heads, nsp, _lns_slice(lns, i))
    return x


# the launch count of a K9 branch beside its kernel's (``<kernel>/<branch>``),
# one per branch off the folded dense route at S <= 64
K9_BRANCHES = ("unfolded", "masked", "masked_f32", "nondense", "long")
for _k in ("block_int8", "layer_fused_int8", "stream_tower_int8"):
    LAUNCHES.update({f"{_k}/{b}": 0 for b in K9_BRANCHES})


def k9_branch(tree: dict, s: int, n_heads: int, dtype: torch.dtype, *, causal: bool = False,
              dense: bool = True) -> str:
    """The branch a K9 launch takes: "masked_f32" (f32 rows) or "masked"
    (causal, or an odd head count), "nondense" (mask-free at S a multiple
    of 16), "unfolded" (dense), "long" (folded dense at 65 to 127 tokens),
    or "" (the folded dense route at S <= 64)."""
    if dtype == torch.float32:
        return "masked_f32"
    if causal or n_heads % 2:
        return "masked"
    if not dense:
        return "nondense"
    if not tree.get("quant_folded", False):
        return "unfolded"
    return "long" if s > CLS_MAX_SEQ else ""


def _int8_operands(name: str, x: torch.Tensor, tree: dict, flags: int, n_layers: int,
                   lns=(None, None)) -> list:
    """The int8 layer kernel's 21 operands in its C entry's order, each
    checked against ``n_layers`` layers of the tree: the four weights with
    their scales and biases (c_fc's with a static h_inv folded in), the
    static scalars the mode names (ln_inv of both halves, ctx_inv,
    gelu_c = 0.851 / h_inv or 0.851, the score shift; None where the tree
    keeps the quantization dynamic) and the unfolded tree's (ln_1, ln_2)
    affines in x's dtype (None when folded)."""
    e = x.shape[1]
    attn, mlp = tree["attn"], tree["mlp"]
    wq, wo, fc, pr = attn["w_qkv"], attn["w_out"], mlp["c_fc"], mlp["c_proj"]
    hidden = _hidden(tree)
    if flags & FLAG_STATIC_H:
        h_inv = mlp["h_inv"].reshape(-1, 1)
        fc_sc, fc_b, gelu_c = fc.w_scale * h_inv, fc.bias * h_inv, GELU_TANH_COEF / h_inv
    else:
        fc_sc, fc_b = fc.w_scale, fc.bias
        gelu_c = torch.full((n_layers,), GELU_TANH_COEF, dtype=torch.float32, device=x.device)
    ops = [wq.w_int8, wq.w_scale, wq.bias, wo.w_int8, wo.w_scale, wo.bias,
           fc.w_int8, fc_sc, fc_b, pr.w_int8, pr.w_scale, pr.bias,
           attn.get("ln_inv"), attn.get("ctx_inv"), mlp.get("ln_inv"), gelu_c,
           attn.get("score_shift")] + [None if ln is None else ln[k] for ln in lns
                                       for k in ("scale", "bias")]
    shapes = [(3 * e, e), (3 * e,), (3 * e,), (e, e), (e,), (e,), (hidden, e), (hidden,),
              (hidden,), (e, hidden), (e,), (e,), (), (), (), (), (), (e,), (e,), (e,), (e,)]
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        if t is None:
            continue
        want = torch.int8 if i in (0, 3, 6, 9) else x.dtype if i >= 17 else torch.float32
        if (t.dtype != want or t.device != x.device or t.numel() != n_layers * math.prod(shape)
                or (shape and tuple(t.shape[-len(shape):]) != shape)):
            raise ValueError(f"{name}: operand {i} must be {want} {shape} per layer, {n_layers} "
                             f"layer(s), on {x.device}; got {t.dtype} {tuple(t.shape)}")
    return ops


def _layers_plan(name: str, x: torch.Tensor, tree: dict, s: int, n_heads: int, n_layers: int,
                 nsp: int, mid_f32: bool, lns=(None, None), *, causal: bool = False,
                 dense: bool = True) -> dict:
    """The checked operands of the persistent int8 layer kernel
    (csrc/block_int8.cu) for rows x [B' * S, E] with a (one-layer or
    stacked) tree on the route ``run_fused_tower`` picks (``causal``, an
    odd head count: the masked attention; else the pair attention, its
    shift floored on the ``dense`` route): the flags, the operands in the C
    entry's order, the scratch sizes. Raises ValueError on what the kernel
    does not take; launches nothing, so it runs on CPU tensors too."""
    rows, e = x.shape
    if (x.dtype not in _FLOAT or rows < 1 or rows % s or not 1 <= s <= MAX_SEQ
            or e != 64 * n_heads or e > 1024):
        raise ValueError(f"{name} takes bf16 or f32 rows of S <= {MAX_SEQ} tokens, heads of dim "
                         f"64 and E up to 1024; got {x.dtype} {tuple(x.shape)}, S={s}, "
                         f"H={n_heads}")
    masked = causal or n_heads % 2 == 1
    f32 = x.dtype == torch.float32
    flags = (quant_flags(tree, dense=dense, use_mask=masked) | (FLAG_CAUSAL if causal else 0)
             | (FLAG_F32_ROWS if f32 else 0))
    if flags & FLAG_USE_MASK and flags & FLAG_DENSE or flags & FLAG_CAUSAL and not flags & FLAG_USE_MASK:
        raise ValueError(f"{name}: the dense route takes no mask and an even head count; got "
                         f"causal={causal}, {n_heads} heads, flags {flags:#x}")
    if (masked or f32) and not (mid_f32 and n_layers == 1):
        raise ValueError(f"{name}: the masked attention and f32 rows are K9a's, one layer with "
                         f"the f32 mid; got {x.dtype} rows, causal={causal}, {n_heads} heads")
    static = FLAG_STATIC_ACT | FLAG_STATIC_CTX | FLAG_STATIC_H | FLAG_STATIC_SHIFT
    if f32 and flags & static:
        raise ValueError(f"{name}: f32 rows take the folded dynamic tree or the unfolded one; "
                         f"flags {flags:#x}")
    hidden = _hidden(tree)
    if hidden % 128 or hidden % nsp or (hidden // nsp) % 64 or hidden // nsp < 128:
        raise ValueError(f"{name} needs a hidden width divisible by 128 in chunks of a multiple of "
                         f"64 columns, at least 128; got {hidden} in {nsp} chunks")
    # the LN affines go to the kernel in f32 (the plain version's math)
    ops = [None if t is None else (t.float() if i >= 17 else t).contiguous()
           for i, t in enumerate(_int8_operands(name, x, tree, flags, n_layers, lns))]
    static_ctx, static_h = bool(flags & FLAG_STATIC_CTX), bool(flags & FLAG_STATIC_H)
    dynamic = not (flags & FLAG_STATIC_ACT) or not static_ctx
    return {"flags": flags, "ops": ops, "hidden": hidden,
            # bytes a row of qkv (bf16), then of the dynamic f32 hidden
            "big": max(6 * e, 0 if static_h else 4 * hidden),
            "f32s": not static_ctx or nsp > 1, "rsc": dynamic, "hsc": not static_h}


def _launch_layers(name: str, x: torch.Tensor, tree: dict, s: int, n_heads: int, n_layers: int,
                   nsp: int, mid_f32: bool, *, lns=(None, None), causal: bool = False,
                   dense: bool = True, grid: int = 0) -> torch.Tensor:
    """Launches the persistent int8 layer kernel (csrc/block_int8.cu) as
    K9a (``mid_f32``, one layer, on its route), K9d (one layer) or K9c
    (every layer of the stacked tree) on CUDA rows x: one cooperative
    launch, the scratch from here. ``grid``: 0 for the occupancy's blocks
    (only the GPU tests pass more, which the runtime refuses)."""
    plan = _layers_plan(name, x, tree, s, n_heads, n_layers, nsp, mid_f32, lns, causal=causal,
                        dense=dense)
    rows, e = x.shape
    x = x.contiguous()
    out = torch.empty_like(x)
    dev, hidden = x.device, plan["hidden"]

    def buf(n, dt, need=True):
        return torch.empty(n, dtype=dt, device=dev) if need else None

    scratch = [buf(rows * e, torch.int8), buf(rows * plan["big"], torch.uint8),
               buf(rows * hidden, torch.int8), buf(rows * e, torch.float32, plan["f32s"]),
               buf(rows * e, torch.float32, mid_f32), buf(rows, torch.float32, plan["rsc"]),
               buf(rows * nsp, torch.float32, plan["hsc"]),
               buf(3, torch.int32)]  # the grid barrier, the tile and round counters
    lib = _build.load()
    err = lib.jcf_int8_layers(
        int(mid_f32), x.data_ptr(), out.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scratch),
        *(t.data_ptr() if t is not None else None for t in plan["ops"]), rows // s, s, n_heads,
        hidden, n_layers, nsp, plan["flags"], grid, _build.stream_ptr(dev))
    _build.check(err, name)
    LAUNCHES[name] += 1
    branch = k9_branch(tree, s, n_heads, x.dtype, causal=causal, dense=dense)
    if branch:
        LAUNCHES[f"{name}/{branch}"] += 1
    return out


def block_int8(x: torch.Tensor, layer: dict, s: int, n_heads: int, *, lns=(None, None),
               causal: bool = False, dense: bool = True) -> torch.Tensor:
    """K9a on rows x [B' * S, E] (bf16, or f32 on the masked route) with
    one layer's tree, folded (any mode) or unfolded (``lns``: its (ln_1,
    ln_2) affines in x's dtype), on the route ``run_fused_tower`` picks
    (``causal``, an odd head count, ``dense``) -> the layer's output rows
    in x's dtype: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check_k9("block_int8", layer, n_heads, lns, causal=causal, dense=dense)
    if not x.is_cuda:
        return block_int8_plain(x, layer, s, n_heads, lns=lns, causal=causal, dense=dense)
    return _launch_layers("block_int8", x, layer, s, n_heads, 1, _chunks(_MLP_NSPLIT, _hidden(layer)),
                          True, lns=lns, causal=causal, dense=dense)


def layer_fused_int8(x: torch.Tensor, layer: dict, s: int, n_heads: int, *,
                     lns=(None, None)) -> torch.Tensor:
    """K9d, as ``block_int8`` on the dense route with the mid rounded to
    bf16 and the MLP in ``_LAYER_NSPLIT`` chunks: the persistent kernel's
    one-layer launch with K9c's bf16 mid."""
    _check_k9("layer_fused_int8", layer, n_heads, lns)
    if not x.is_cuda:
        return layer_fused_int8_plain(x, layer, s, n_heads, lns=lns)
    return _launch_layers("layer_fused_int8", x, layer, s, n_heads, 1,
                          _chunks(_LAYER_NSPLIT, _hidden(layer)), False, lns=lns)


def stream_tower_int8(x: torch.Tensor, quant: dict, n_heads: int, *, s: int,
                      lns=(None, None)) -> torch.Tensor:
    """K9c: every layer of the stacked tree (folded in any mode, or
    unfolded with ``lns`` its stacked [L, E] affines in x's dtype) on every
    row of x [B' * S, E] bf16 on the dense route, one launch -> [B' * S, E]
    bf16."""
    _check_k9("stream_tower_int8", quant, n_heads, lns)
    if not x.is_cuda:
        return stream_tower_int8_plain(x, quant, n_heads, s=s, lns=lns)
    n_layers = quant["attn"]["w_qkv"].w_int8.shape[0]
    return _launch_layers("stream_tower_int8", x, quant, s, n_heads, n_layers,
                          _chunks(_MLP_NSPLIT, _hidden(quant)), False, lns=lns)


def _block_float_plain(x: torch.Tensor, layer: dict, s: int, n_heads: int, bias: torch.Tensor,
                       dt: torch.dtype) -> torch.Tensor:
    """K9b's math (``_block_kernel``) in the rows' dtype ``dt``: the LN
    affine and weights cast to ``dt``, biases f32, f32 statistics and sums;
    qkv and the context rounded to ``dt``; the mid residual in f32;
    QuickGELU as h * sigmoid(1.702 h) in f32, the hidden rounded to
    ``dt``."""
    ln1, ln2, attn, mlp = layer["ln_1"], layer["ln_2"], layer["attn"], layer["mlp"]
    h = ln_affine_plain(x, ln1["scale"].to(dt), ln1["bias"].to(dt))
    qkv = (matmul_plain(h, attn["w_qkv"].to(dt)) + attn["b_qkv"].float()).to(dt)
    ctx = bias_attention_plain(qkv, s, n_heads, bias)
    mid = x.float() + (matmul_plain(ctx, attn["w_out"].to(dt)) + attn["b_out"].float())
    h2 = ln_affine_plain(mid, ln2["scale"].to(dt), ln2["bias"].to(dt))
    g = matmul_plain(h2, mlp["c_fc"]["w"].to(dt)) + mlp["c_fc"]["b"].float()
    hid = (g * torch.sigmoid(1.702 * g)).to(dt)
    return (mid + (matmul_plain(hid, mlp["c_proj"]["w"].to(dt)) + mlp["c_proj"]["b"].float())).to(dt)


def block_bf16_plain(x: torch.Tensor, layer: dict, s: int, n_heads: int,
                     bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K9b (``_block_kernel``): one bf16 layer of float
    block params on rows x [B * S, E] bf16 with an additive [S, S] f32
    bias. LN affine in bf16, f32 math; bf16 qkv; the context in bf16; the
    mid residual in f32; QuickGELU as h * sigmoid(1.702 h) in f32."""
    return _block_float_plain(x, layer, s, n_heads, bias, torch.bfloat16)


def block_f32_plain(x: torch.Tensor, layer: dict, s: int, n_heads: int,
                    bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K9b in f32 (``_block_kernel`` at
    ``Precision.HIGHEST``): one f32 layer on rows x [B * S, E] f32 with an
    additive [S, S] f32 bias, every product and sum exact f32 (no TF32;
    the kernel takes each product as three TF32 products)."""
    return _block_float_plain(x, layer, s, n_heads, bias, torch.float32)


def _chunk_seqs(n_seq: int, chunk: int | None) -> int:
    """K9b's sequences a chunk: all ``n_seq`` in one chunk, every
    intermediate through device memory as between the halves (chunks sized
    so that a phase's operands stay in the 50 MB L2 were 36-52% slower at
    all four shapes on one H100, as PERF.md records), unless ``chunk``
    forces fewer; the kernel's last chunk is what is left."""
    if chunk is None:
        return n_seq
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int of sequences, got {chunk!r}")
    return min(chunk, n_seq)


def _block_float(name: str, x: torch.Tensor, layer: dict, s: int, n_heads: int,
                 bias: torch.Tensor, dt: torch.dtype, chunk: int | None = None) -> torch.Tensor:
    """Launches K9b (csrc/block_float.cu) on checked CUDA rows: one
    persistent launch for the layer, chunk scratch from the wrapper;
    ``chunk`` (``_chunk_seqs``) is set only by the GPU tests."""
    rows, e = x.shape
    hidden = layer["mlp"]["c_fc"]["w"].shape[0]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (s, s) or bias.device != x.device:
        raise ValueError(f"bias must be f32 ({s}, {s}) on {x.device}")
    ln1, ln2, attn, mlp = layer["ln_1"], layer["ln_2"], layer["attn"], layer["mlp"]
    ops = [ln1["scale"].to(dt), ln1["bias"].to(dt), attn["w_qkv"].to(dt), attn["b_qkv"].float(),
           attn["w_out"].to(dt), attn["b_out"].float(), ln2["scale"].to(dt), ln2["bias"].to(dt),
           mlp["c_fc"]["w"].to(dt), mlp["c_fc"]["b"].float(), mlp["c_proj"]["w"].to(dt),
           mlp["c_proj"]["b"].float(), bias]
    shapes = [(e,), (e,), (3 * e, e), (3 * e,), (e, e), (e,), (e,), (e,), (hidden, e), (hidden,),
              (e, hidden), (e,), (s, s)]
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: operand {i} must be {shape} on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    ops = [t.contiguous() for t in ops]
    x = x.contiguous()
    n_seq = rows // s
    seqs = _chunk_seqs(n_seq, chunk)
    f32 = dt == torch.float32
    if f32:  # the kernel reads the weights' TF32 planes [2, N, K] from the tree
        for i, (o, k) in zip((2, 4, 8, 10), ((attn, "w_qkv"), (attn, "w_out"), (mlp["c_fc"], "w"),
                                             (mlp["c_proj"], "w"))):
            ops[i] = need_planes(o.get(planes_key(k)), o[k], name)
    c = seqs * s  # the kernel walks chunks of seqs sequences, the last one what is left
    out = torch.empty_like(x)
    rows_e = torch.empty(c * e, dtype=dt, device=x.device)
    rows_b = torch.empty(c * max(3 * e, hidden), dtype=dt, device=x.device)
    mid = torch.empty(c * e, dtype=torch.float32, device=x.device)
    bar = torch.empty(2, dtype=torch.int32, device=x.device)  # the grid barrier, the tile counter
    lib = _build.load()
    err = lib.jcf_block_float(int(f32), x.data_ptr(), out.data_ptr(), rows_e.data_ptr(),
                              rows_b.data_ptr(), mid.data_ptr(), bar.data_ptr(),
                              *(t.data_ptr() for t in ops), n_seq, s, n_heads, hidden, seqs,
                              1.0 / math.sqrt(e // n_heads), _build.stream_ptr(x.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def block_bf16(x: torch.Tensor, layer: dict, s: int, n_heads: int,
               bias: torch.Tensor) -> torch.Tensor:
    """K9b wrapper: the CUDA kernel (csrc/block_float.cu) for CUDA tensors,
    the plain version for CPU tensors. Weights are cast to bf16, biases
    kept f32, as the reference casts them. One persistent launch a layer
    over all the rows, every product on wgmma; it raises where the grid
    cannot be co-resident."""
    if not x.is_cuda:
        return block_bf16_plain(x, layer, s, n_heads, bias)
    rows, e = x.shape
    hidden = layer["mlp"]["c_fc"]["w"].shape[0]
    if (x.dtype != torch.bfloat16 or rows % s or s > 80 or e != 64 * n_heads or e % 128
            or e > 1024 or hidden % 128):
        raise ValueError(f"block_bf16 takes bf16 rows of S <= 80 tokens, head dim 64, E and the "
                         f"hidden width multiples of 128 (E <= 1024); got {x.dtype} "
                         f"{tuple(x.shape)}, S={s}, H={n_heads}, hidden={hidden}")
    return _block_float("block_bf16", x, layer, s, n_heads, bias, torch.bfloat16)


def block_f32(x: torch.Tensor, layer: dict, s: int, n_heads: int,
              bias: torch.Tensor) -> torch.Tensor:
    """K9b in f32 (csrc/block_float.cu): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. One persistent launch a layer, as
    ``block_bf16``, each product as three TF32 products on wgmma (the f32
    GEMM's split): the weights' hi and lo planes come from the layer
    (``ops.f32_gemm.with_tf32_planes``; without them it raises), so no
    other launch."""
    if not x.is_cuda:
        return block_f32_plain(x, layer, s, n_heads, bias)
    rows, e = x.shape
    hidden = layer["mlp"]["c_fc"]["w"].shape[0]
    if (x.dtype != torch.float32 or rows % s or s > 80 or e != 64 * n_heads or e % 16
            or e > 1024 or hidden % 16):
        raise ValueError(f"block_f32 takes f32 rows of S <= 80 tokens, head dim 64, E <= 1024 and "
                         f"E and the hidden width multiples of 16; got {x.dtype} "
                         f"{tuple(x.shape)}, S={s}, H={n_heads}, hidden={hidden}")
    return _block_float("block_f32", x, layer, s, n_heads, bias, torch.float32)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def _fuse() -> str:
    if _FUSE not in FUSE_MODES:
        raise ValueError(f"_FUSE must be one of {FUSE_MODES}, got {_FUSE!r}")
    return _FUSE


def _halves_int8(x: torch.Tensor, layer: dict, s: int, n_heads: int, lns=(None, None), *,
                 causal: bool = False, dense: bool = True) -> torch.Tensor:
    """K3 then K4 on one layer; ``lns`` the unfolded tree's (ln_1, ln_2)
    affines in x's dtype, or (None, None) for the folded tree."""
    mid = attn_half_int8(x, layer["attn"], s, n_heads, ln=lns[0], causal=causal, dense=dense)
    return mlp_half_int8(mid, layer["mlp"], ln=lns[1])


def dense_rows_eligible(s: int, n_heads: int) -> bool:
    """True iff ``run_fused_tower`` takes the reference's dense route for a
    mask-free tower of ``s`` tokens (``jcf_tpu`` ``dense_rows_eligible``):
    an even head count (the paired attention) and S not a multiple of 16
    (else the padded length equals S). The engine's row assembly (K2)
    feeds that route only."""
    return n_heads % 2 == 0 and s % 16 != 0


def _layer_ln(blocks, i: int, name: str, dt):
    """Layer i's LN affine ``name`` from the stacked float blocks, cast to
    ``dt`` (None: as the blocks hold it)."""
    ln = blocks[name]
    return {k: ln[k][i] if dt is None else ln[k][i].to(dt) for k in ("scale", "bias")}


def run_fused_tower(x: torch.Tensor, quant: dict, n_heads: int, *, flat_s: int,
                    cls_only: bool = True, blocks: dict | None = None,
                    causal: bool = False) -> torch.Tensor:
    """All layers over flat rows x [B' * S, E] (bf16 or f32) -> the CLS
    rows [B', E] (``cls_only``) or every row [B' * S, E], in x's dtype.

    ``quant`` is a tree of ``quantize_clip_params`` (layers stacked on the
    leading axis): folded in any of its modes, or unfolded, whose LN
    affine the halves read from the stacked float ``blocks`` (the JAX
    function's ``stacked_blocks``; not read for a folded tree). ``causal``
    is the text tower's mask, the only mask the towers take.

    The route is the reference's: dense (no mask, an even head count, S
    not a multiple of 16) or not. On the dense route, under ``_FUSE`` =
    "halves" each layer is K3 + K4, under "block" K9a and under "layer"
    K9d; with ``cls_only`` the last layer's MLP half runs on the CLS rows
    only, since nothing downstream reads the other rows, after K5 (the CLS
    rows attend to every token) for S <= 64, or after K3 on all rows from
    65 tokens on (the reference's ``_CLS_ATTNQ`` gate); under "stream" one
    K9c runs every layer on every row. The non-dense route (the masked
    attention of a causal or odd-head tower, or the mask-free one at S a
    multiple of 16) runs every layer on every row, then takes the CLS
    rows: K9a per layer under "block", the halves under "halves", "layer"
    and "stream", as the JAX package falls back. The K9 kernels take the
    folded tree in every mode (dynamic, "ln", "hidden", "full", each
    "+score") and the unfolded one (its LN affines from ``blocks``, cast
    to x's dtype, stacked for K9c).
    """
    s = flat_s
    folded = quant.get("quant_folded", False)
    if not folded and blocks is None:
        raise ValueError("an unfolded tree takes its LN affine from the float blocks: pass blocks")
    use_mask = causal or n_heads % 2 == 1
    dense = not use_mask and s % 16 != 0
    fuse = _fuse()
    dt = x.dtype

    def lns(i):
        """Layer i's (ln_1, ln_2) affines in x's dtype (all layers' for
        None), or none for the folded tree."""
        if folded:
            return None, None
        if i is None:
            return tuple({k: blocks[n][k].to(dt) for k in ("scale", "bias")}
                         for n in ("ln_1", "ln_2"))
        return _layer_ln(blocks, i, "ln_1", dt), _layer_ln(blocks, i, "ln_2", dt)

    if fuse == "stream" and dense:
        out = stream_tower_int8(x, quant, n_heads, s=s, lns=lns(None))
        return out[::s].contiguous() if cls_only else out
    n_layers = quant["attn"]["w_qkv"].w_int8.shape[0]
    cls_route = cls_only and dense
    for i in range(n_layers - 1 if cls_route else n_layers):
        layer = layer_slice(quant, i)
        if fuse == "block":
            x = block_int8(x, layer, s, n_heads, lns=lns(i), causal=causal, dense=dense)
        elif fuse == "layer" and dense:
            x = layer_fused_int8(x, layer, s, n_heads, lns=lns(i))
        else:
            x = _halves_int8(x, layer, s, n_heads, lns(i), causal=causal, dense=dense)
    if not cls_route:
        return x[::s].contiguous() if cls_only else x
    last, i = layer_slice(quant, n_layers - 1), n_layers - 1
    ln1 = lns(i)[0]
    if s <= CLS_MAX_SEQ:
        mid = attn_cls_int8(x, last["attn"], s, n_heads, ln=ln1)
    else:
        mid = attn_half_int8(x, last["attn"], s, n_heads, ln=ln1)[::s].contiguous()
    # the CLS rows' LN affine as the layer params hold it, one hidden chunk
    # (_mlp_half_cls_rows)
    return mlp_half_int8(mid, last["mlp"], ln=None if folded else _layer_ln(blocks, i, "ln_2", None),
                         nsp=1)


def run_float_tower(x: torch.Tensor, blocks: dict, n_heads: int, *, s: int,
                    causal: bool) -> torch.Tensor:
    """``run_fused_tower`` without a quant tree: rows x [B * S, E], bf16 or
    f32, through all layers of the stacked float ``blocks`` -> [B * S, E]
    in x's dtype, causal (the text tower) or mask-free (the float vision
    towers, S <= 127 and an even head count).

    Under ``_FUSE`` = "block" each layer is K9b (``block_bf16`` on bf16
    rows, ``block_f32`` on f32 rows) with the causal mask or an all-zero
    [S, S] bias (the reference's bias once its pad keys are dropped).
    Under every other value the halves (K6a, K6b), as the JAX package
    falls back. The TPU pads S to a multiple of 8 (pad keys masked by
    -1e30, or zeroed and floored into the pair shift); pad rows never
    reach real rows, so the port runs unpadded."""
    fuse = _fuse()
    if fuse == "block":
        if x.dtype not in _FLOAT:
            raise ValueError(f"the float tower takes bf16 or f32 rows, got {x.dtype}")
        whole = block_bf16 if x.dtype == torch.bfloat16 else block_f32
        bias = (causal_mask(s, x.device) if causal
                else torch.zeros((s, s), dtype=torch.float32, device=x.device))
    for i in range(blocks["attn"]["w_qkv"].shape[0]):
        layer = layer_slice(blocks, i)
        if fuse == "block":
            x = whole(x, layer, s, n_heads, bias)
        else:
            x = mlp_half(attn_half(x, layer, s, n_heads, causal=causal), layer)
    return x
