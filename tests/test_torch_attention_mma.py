"""The arithmetic of the port's tensor-core attention kernels
(``csrc/attn_mma.cuh``) on the CPU: the masked attention on bf16 qkv
(``csrc/text_block.cu`` ``masked_attention_mma_kernel``) and K7's bf16
backward (``csrc/packed_attn.cu`` ``packed_attn_bwd_mma_kernel``), and the
route between them and the CUDA-core row loop.

The kernels run only on the card. Here each is emulated in numpy, step by
step as the kernel rounds: the scores on the CUDA cores in the
reference's order (one fmaf after another over the 64 dims, as
torch.matmul sums an f32 product), the row max and the row sum across
the warp's lanes as the CUDA-core row loop takes them (lane l sums keys
l, l + 32, ... in turn, then the xor butterfly), p / sum as the kernel
divides (``div_rcp``: one reciprocal a row, then q = RN(a y), r = a - b
q, RN(q + r y)), p rounded to bf16; the products after it on the tensor
cores (bf16 products summed exactly, rounded once to f32); in the
backward dP rounded to bf16, its row sums with p in the quad's order
(each of the four threads fmaf-sums its keys 8 t + 2 tig + e in turn,
then (s0 + s1) + (s2 + s3)), dS split into hi = bf16(dS) and lo =
bf16(dS - hi), both multiplied in. The emulations are held against the
JAX package (the masked route of ``_batched_attention``, and ``jax.vjp``
of ``_packed_attention_ref``) and against the port's plain versions,
which ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernels
against on the card, at the bars stated in each test."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.ops.attention import causal_mask
from jcf_tpu_torch.ops import attention as tattn
from jcf_tpu_torch.ops import block_kernel as tbk

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64
CROPS = 3


def _bf16(x):
    """f32 values rounded to bf16 (to nearest, ties to even), kept in f32."""
    return torch.from_numpy(np.array(x, np.float32)).bfloat16().float().numpy()


def _mm(a, b):
    """An mma's product: f32 operands multiplied and summed exactly (in
    f64, exact for bf16 operands at these sizes), rounded once to f32."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _quad_sum(x, fma_with=None):
    """Row sums over the last axis (16 NC keys) in the quad's order: thread
    tig sums keys 8 t + 2 tig + e for t, then e, in f32 (with
    ``fma_with``: fmaf(x, fma_with, acc), one rounding a step), then (s0
    + s1) + (s2 + s3)."""
    kp = x.shape[-1]
    parts = []
    for tig in range(4):
        acc = np.zeros(x.shape[:-1], np.float32)
        for t in range(kp // 8):
            for e in range(2):
                j = 8 * t + 2 * tig + e
                if fma_with is None:
                    acc = (acc + x[..., j]).astype(np.float32)
                else:
                    acc = (acc.astype(np.float64)
                           + x[..., j].astype(np.float64) * fma_with[..., j]).astype(np.float32)
        parts.append(acc)
    return ((parts[0] + parts[1]).astype(np.float32) + (parts[2] + parts[3])).astype(np.float32)


def _div_rcp(a, b):
    """a / b as the kernels divide: y = RN(1 / b), q = RN(a y), r = a - b q
    (exact), RN(q + r y)."""
    b = np.broadcast_to(b, a.shape).astype(np.float32)
    y = (1.0 / b.astype(np.float64)).astype(np.float32)
    q = (a.astype(np.float64) * y).astype(np.float32)
    r = (a.astype(np.float64) - b.astype(np.float64) * q).astype(np.float32)
    return (q.astype(np.float64) + r.astype(np.float64) * y).astype(np.float32)


def _seq_dot(a, b):
    """a @ b^T as the reference sums it (torch.matmul in f32) and the
    kernels' CUDA-core scores: one fmaf after another over the last axis
    (f64 holds each exact step; one f32 rounding a step)."""
    acc = np.zeros(a.shape[:-1] + (b.shape[-2],), np.float32)
    for d in range(a.shape[-1]):
        acc = (acc.astype(np.float64) + a[..., d, None].astype(np.float64)
               * b[..., None, :, d].astype(np.float64)).astype(np.float32)
    return acc


def _lane_sum(x):
    """Row sums over the last axis as a warp takes them with lanes over
    keys: lane l sums keys l, l + 32, ... in turn (f32), then the xor
    butterfly over 16, 8, 4, 2, 1."""
    n = -(-x.shape[-1] // 32) * 32
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])
    parts = x[..., 0::1].reshape(x.shape[:-1] + (n // 32, 32))
    acc = np.zeros(parts.shape[:-2] + (32,), np.float32)
    for sl in range(n // 32):
        acc = (acc + parts[..., sl, :]).astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        acc = (acc + acc[..., np.arange(32) ^ o]).astype(np.float32)
    return acc[..., 0]


def _softmax_rows(sc):
    """p = exp(s - m) / sum over the last axis as the kernels take it: the
    row max, exp of the f32 difference, the lanes' sums, div_rcp; -inf
    scores give 0."""
    m = sc.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        p = np.exp((sc - m).astype(np.float32)).astype(np.float32)
    p[np.isneginf(sc)] = 0.0
    return _div_rcp(p, _lane_sum(p)[..., None])


def _pad_keys(x, kp):
    """[..., S, D] -> [..., KP, D], zero rows past S (the staged chunks)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(0, kp - x.shape[-2]), (0, 0)]
    return np.pad(x, pad)


def _heads(qkv, s, h, parts=3):
    """Flat bf16 rows [B * S, parts E] -> f32 [parts, B, H, S, D]."""
    a = qkv.float().numpy()
    return a.reshape(-1, s, parts, h, D).transpose(2, 0, 3, 1, 4)


# ---------------------------------------------------------------------------
# the masked attention on bf16 qkv
# ---------------------------------------------------------------------------


def masked_emulated(qkv, s, h, *, causal, scale, kind, ctx_inv=None):
    """``masked_attention_mma_kernel``'s arithmetic on bf16 qkv [B * S, 3E]
    -> the context [B * S, E] of ``kind``: "f32", "bf16" or "int8"
    (int8(round(ctx x ctx_inv)))."""
    q, k, v = _heads(qkv, s, h)
    kp = 16 * -(-s // 16)
    k, v = _pad_keys(k, kp), _pad_keys(v, kp)
    sc = (_seq_dot(q, k) * np.float32(1.0 if scale is None else scale)).astype(np.float32)
    i, j = np.arange(s)[:, None], np.arange(kp)[None, :]
    sc[..., (j >= s) | ((j > i) & causal)] = -np.inf
    ctx = _mm(_bf16(_softmax_rows(sc)), v)  # [B, H, S, D]
    ctx = ctx.transpose(0, 2, 1, 3).reshape(-1, h * D)
    if kind == "f32":
        return ctx
    if kind == "bf16":
        return _bf16(ctx)
    return np.clip(np.rint((ctx * np.float32(ctx_inv)).astype(np.float32)), -127, 127)


def _jax_masked(qkv, s, n_heads, *, causal, scale, post_scale=None):
    """``_batched_attention(use_mask=True)`` on the reference's layout (S
    padded to a multiple of 8, pad keys at -1e30) -> the f32 context of
    the real rows [B * S, E] (x post_scale)."""
    e = qkv.shape[1] // 3
    b, s_pad = qkv.shape[0] // s, -(-s // 8) * 8
    x = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16).reshape(b, s, 3 * e)
    q3 = jnp.pad(x, ((0, 0), (0, s_pad - s), (0, 0))).reshape(b * s_pad, 3 * e)
    block = causal_mask(s) if causal else jnp.zeros((s, s), jnp.float32)
    bias = jnp.full((s_pad, s_pad), jbk._NEG_INF, jnp.float32).at[:s, :s].set(block)
    out = jbk._batched_attention(q3, bias, n_heads, e // n_heads, scale, b, s_pad, s_real=s,
                                 use_mask=True,
                                 post_scale=None if post_scale is None else jnp.float32(post_scale))
    return np.asarray(out.astype(jnp.float32)).reshape(b, s_pad, e)[:, :s].reshape(-1, e)


def _masked_qkv(s, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((CROPS * s, 3 * h * D)).astype(np.float32) * 1.5
    return torch.from_numpy(x).bfloat16()


def _slack(qkv, s, h, causal, scale):
    """2^-7 sum_j p_j |v_j|: the move of a p that rounds to bf16 across a
    tie when two sides sum the scores in other orders."""
    e = h * D
    v_abs = torch.cat([qkv[:, : 2 * e], qkv[:, 2 * e :].abs()], 1)
    return 2.0**-7 * tbk.masked_attention_plain(v_abs, s, h, causal=causal, scale=scale,
                                                f32_ctx=True).numpy()


def _close_int8(got, ref, share):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


# (S, heads, causal, scaled): the int8 text tower (77, causal, unfolded),
# odd heads without a mask (50), the folded tree's tiny tower (17), whole
# chunks (64), the kernel's longest rows (127, 128)
MASKED = [(77, 2, True, True), (50, 3, False, True), (17, 1, False, False), (64, 2, True, False),
          (127, 1, True, True), (128, 2, False, True)]


@pytest.mark.parametrize("s,h,causal,scaled", MASKED)
def test_masked_emulation_matches_jax(s, h, causal, scaled):
    """The masked kernel's arithmetic against the JAX package's masked
    route (XLA on the CPU) on bf16 qkv, each output kind at
    ``tests/test_torch_masked_int8.py``'s bars: the f32 context within
    1e-5 + 1e-5 |ref| + 2^-7 sum_j p_j |v_j| (p rounds to bf16 on one
    side: CPU XLA keeps it in f32), the int8 context (ctx x 40) off by at
    most 1 on <= 2% of the elements, the bf16 context within 1 bf16 ulp +
    1e-3 + that slack."""
    qkv = _masked_qkv(s, h, s + 10 * h)
    scale = 0.125 if scaled else None
    kw = dict(causal=causal, scale=scale)
    ref = _jax_masked(qkv, s, h, **kw)
    slack = _slack(qkv, s, h, causal, scale)
    got = masked_emulated(qkv, s, h, kind="f32", **kw)
    assert (np.abs(got - ref) <= 1e-5 + 1e-5 * np.abs(ref) + slack).all()
    ref8 = np.clip(np.round(_jax_masked(qkv, s, h, post_scale=40.0, **kw)), -127, 127)
    _close_int8(masked_emulated(qkv, s, h, kind="int8", ctx_inv=40.0, **kw), ref8, 2e-2)
    got16, ref16 = masked_emulated(qkv, s, h, kind="bf16", **kw), _bf16(ref)
    tol = 2.0**-7 * np.maximum(np.abs(got16), np.abs(ref16)) + 1e-3 + slack
    assert (np.abs(got16 - ref16) <= tol).all()


@pytest.mark.parametrize("s,h,causal,scaled", MASKED)
def test_masked_emulation_within_the_cards_bars(s, h, causal, scaled):
    """The same arithmetic against ``masked_attention_plain``, the card's
    reference, at the card's bars (``chip_smoke.py``): f32 within 1e-5 +
    1e-5 |ref| + 2^-7 sum_j p_j |v_j|, int8 (ctx x 30) off by at most 1 on
    <= 1e-2, bf16 within 1 bf16 ulp + 1e-3 + that slack."""
    qkv = _masked_qkv(s, h, s + h)
    scale = 0.125 if scaled else None
    kw = dict(causal=causal, scale=scale)
    slack = _slack(qkv, s, h, causal, scale)
    ref = tbk.masked_attention_plain(qkv, s, h, f32_ctx=True, **kw).numpy()
    got = masked_emulated(qkv, s, h, kind="f32", **kw)
    assert (np.abs(got - ref) <= 1e-5 + 1e-5 * np.abs(ref) + slack).all()
    ctx_inv = torch.tensor([[30.0]])
    ref8 = tbk.masked_attention_plain(qkv, s, h, ctx_inv=ctx_inv, **kw).numpy()
    _close_int8(masked_emulated(qkv, s, h, kind="int8", ctx_inv=30.0, **kw), ref8, 1e-2)
    ref16 = tbk.masked_attention_plain(qkv, s, h, **kw).float().numpy()
    got16 = masked_emulated(qkv, s, h, kind="bf16", **kw)
    tol = 2.0**-7 * np.maximum(np.abs(got16), np.abs(ref16)) + 1e-3 + slack
    assert (np.abs(got16 - ref16) <= tol).all()


def _masked_reference_order(qkv, s, h, scale):
    """The causal bf16 context as ``causal_attention_plain`` computes it on
    the card: both products summed in the reference's order (torch.matmul
    in f32: one fmaf after another), the plain softmax, p in bf16."""
    q, k, v = _heads(qkv, s, h)
    sc = (_seq_dot(q, k) * np.float32(scale)).astype(np.float32)
    sc[..., np.triu(np.ones((s, s), bool), 1)] = -np.inf
    e = np.exp((sc - sc.max(-1, keepdims=True)).astype(np.float32)).astype(np.float32)
    p = (e / e.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
    ctx = _seq_dot(_bf16(p), v.swapaxes(-1, -2))
    return _bf16(ctx.transpose(0, 2, 1, 3).reshape(-1, h * D))


@pytest.mark.parametrize("seed", [0, 3])
def test_reference_order_keeps_the_bf16_context_in_its_bar(seed):
    """Phase 4 of ``chip_smoke.py`` holds the bf16 causal context at 1 bf16
    ulp + 1e-3 with no slack for p's rounding, and so does this test
    (emulated kernel against the reference's arithmetic, 12 prompts x 77
    tokens x 2 heads of 1.5-scaled inputs). Scores summed in another order
    than the reference's, even rounded exactly, put some p near a bf16 tie
    on the other side: with them seed 3 moves 3 elements past the bar."""
    qkv = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (12 * 77, 3 * 2 * D)).astype(np.float32) * 1.5).bfloat16()
    ref = _masked_reference_order(qkv, 77, 2, 0.125)
    got = masked_emulated(qkv, 77, 2, causal=True, scale=0.125, kind="bf16")
    assert (np.abs(got - ref) <= 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3).all()


def test_quad_sums_and_division_as_the_kernel_takes_them():
    """The emulation's pieces: quad-ordered and lane-ordered sums within 2
    f32 ulps of the f64 sum over 80 keys, the sequential fmaf within the
    recursive-sum bound 64 x 2^-24 of the f64 dot product of 64 positive
    dims (seeded bf16 values), and the
    division by reciprocal equal to the IEEE quotient on p in (0, 1] over
    row sums in [1, 128] (the masked kernel's range), bit for bit on
    20,000 seeded cases."""
    rng = np.random.default_rng(0)
    x = rng.random((500, 80)).astype(np.float32)
    ref = x.astype(np.float64).sum(-1)
    for fn in (_quad_sum, _lane_sum):
        assert (np.abs(fn(x) - ref) <= 2 * np.spacing(ref.astype(np.float32))).all()
    q, k = (_bf16(rng.random((50, 64)).astype(np.float32)) for _ in range(2))
    dot = q.astype(np.float64) @ k.astype(np.float64).T
    assert (np.abs(_seq_dot(q, k) - dot) <= 64 * 2.0**-24 * dot).all()
    a = np.exp(-rng.uniform(0, 30, 20000)).astype(np.float32)
    b = rng.uniform(1, 128, 20000).astype(np.float32)
    assert np.array_equal(_div_rcp(a, b), (a / b).astype(np.float32))


# ---------------------------------------------------------------------------
# K7's bf16 backward
# ---------------------------------------------------------------------------


def k7_bwd_emulated(qkv, h, bias, dout, split=True):
    """``packed_attn_bwd_mma_kernel``'s arithmetic: bf16 qkv [B, S, 3E],
    the f32 [S, S] bias and bf16 dout [B, S, E] -> d qkv [B, S, 3E] as
    bf16 values in f32. P recomputed (the scores in the reference's order,
    x scale, then + bias; the row loop's softmax); dP = bf16(dO
    V^T); the row sums of p dP by fmaf in the quad's order; dS = p (dP -
    sum) x scale split into bf16 hi and lo (lo = 0 without ``split``); dQ
    = (hi + lo) K, dK = (hi + lo)^T Q, dV = bf16(p)^T dO, each rounded to
    bf16."""
    b, s, e3 = qkv.shape
    scale = np.float32(1.0 / np.sqrt(D))
    q, k, v = _heads(qkv.reshape(b * s, e3), s, h)
    do = _heads(dout.reshape(b * s, e3 // 3), s, h, parts=1)[0]
    kp = 16 * -(-s // 16)
    q, k, v, do = (_pad_keys(t, kp) for t in (q, k, v, do))
    bias_p = np.zeros((kp, kp), np.float32)  # rows past S: bias 0
    bias_p[:s, :s] = bias
    sc = (_seq_dot(q, k) * scale).astype(np.float32)
    sc = (sc + bias_p).astype(np.float32)
    sc[..., s:] = -np.inf
    p = _softmax_rows(sc)
    dp = _bf16(_mm(do, v.swapaxes(-1, -2)))
    pdp = _quad_sum(p, fma_with=dp)[..., None]
    ds = ((p * (dp - pdp).astype(np.float32)).astype(np.float32) * scale).astype(np.float32)
    hi = _bf16(ds)
    lo = _bf16((ds - hi).astype(np.float32)) if split else np.zeros_like(hi)
    dq = (_mm(hi, k).astype(np.float64) + _mm(lo, k)).astype(np.float32)
    dk = (_mm(hi.swapaxes(-1, -2), q).astype(np.float64)
          + _mm(lo.swapaxes(-1, -2), q)).astype(np.float32)
    dv = _mm(_bf16(p).swapaxes(-1, -2), do)
    grads = np.stack([_bf16(g[:, :, :s]) for g in (dq, dk, dv)], 0)  # [3, B, H, S, D]
    return grads.transpose(1, 3, 0, 2, 4).reshape(b, s, e3)


# (S, heads, bias): the step's text attention (causal), its vision
# attention (zero), a ragged odd-head case with a random finite bias
K7_CASES = [(77, 8, "causal"), (50, 12, "zero"), (23, 3, "random")]

_JAX_SIDE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jcf_tpu.ops.attention import _packed_attention_ref
d = dict(np.load(sys.argv[1]))
out = {}
for key in sorted({k.split(":")[0] for k in d}):
    qkv = jnp.asarray(d[key + ":qkv"]).astype(jnp.bfloat16)
    dout = jnp.asarray(d[key + ":dout"]).astype(jnp.bfloat16)
    h = int(d[key + ":h"])
    _, vjp = jax.vjp(lambda x: _packed_attention_ref(x, h, jnp.asarray(d[key + ":bias"])), qkv)
    out[key] = np.asarray(vjp(dout)[0].astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


def _k7_inputs(s, h, kind):
    rng = np.random.default_rng(s + h)
    qkv = rng.standard_normal((2, s, 3 * h * D)).astype(np.float32)
    dout = rng.standard_normal((2, s, h * D)).astype(np.float32)
    if kind == "causal":
        bias = np.array(causal_mask(s), np.float32)
    elif kind == "zero":
        bias = np.zeros((s, s), np.float32)
    else:
        bias = rng.standard_normal((s, s)).astype(np.float32)
    return _bf16(qkv), bias, _bf16(dout)


@pytest.fixture(scope="module")
def jax_k7(tmp_path_factory):
    """``jax.vjp`` of ``_packed_attention_ref`` in bf16 for every case, from
    one subprocess with XLA's excess precision off (CPU XLA keeps bf16
    intermediates in f32 otherwise; the reference rounds p and dP to bf16
    where the TPU does)."""
    tmp = tmp_path_factory.mktemp("k7")
    arrays = {}
    for s, h, kind in K7_CASES:
        qkv, bias, dout = _k7_inputs(s, h, kind)
        key = f"{s}_{h}_{kind}"
        arrays.update({f"{key}:qkv": qkv, f"{key}:bias": bias, f"{key}:dout": dout,
                       f"{key}:h": np.array(h)})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   cwd=ROOT, env=env, check=True, timeout=300)
    return dict(np.load(tmp / "out.npz"))


def _grad_bars(got, ref):
    """``check_grad_bf16`` (per head row of dQ, dK, dV: cos >= 0.999 where
    the reference row is nonzero, zero rows within 1e-6) and
    ``_bf16_close`` (1 bf16 ulp of the larger value + 1e-3)."""
    g, r = got.reshape(-1, D).astype(np.float64), ref.reshape(-1, D).astype(np.float64)
    live = np.linalg.norm(r, axis=-1) > 0
    cos = (g * r).sum(-1)[live] / (np.linalg.norm(g, axis=-1) * np.linalg.norm(r, axis=-1))[live]
    assert cos.min() >= 0.999, cos.min()
    assert live.all() or np.abs(g[~live]).max() <= 1e-6
    d = np.abs(got - ref)
    assert (d <= 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3).all(), d.max()


@pytest.mark.parametrize("s,h,kind", K7_CASES)
def test_k7_bwd_emulation_matches_jax_vjp(jax_k7, s, h, kind):
    """The bf16 backward's arithmetic (dS as bf16 hi + lo, dP rounded to
    bf16) against ``jax.vjp`` of ``_packed_attention_ref`` in strict bf16,
    at the bars of ``check_grad_bf16`` and ``_bf16_close``."""
    qkv, bias, dout = _k7_inputs(s, h, kind)
    got = k7_bwd_emulated(torch.from_numpy(qkv).bfloat16(), h, bias,
                          torch.from_numpy(dout).bfloat16())
    _grad_bars(got, jax_k7[f"{s}_{h}_{kind}"])


@pytest.mark.parametrize("s,h,kind", K7_CASES)
def test_k7_bwd_emulation_within_the_cards_bars(s, h, kind):
    """The same against ``packed_attention_bwd_plain`` (the card's
    reference: f32 dS, no split), at the same bars; and the split matters:
    dS as bf16 alone (hi only) moves dQ and dK by more than hi + lo does."""
    qkv, bias, dout = _k7_inputs(s, h, kind)
    tq, td = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(dout).bfloat16()
    ref = tattn.packed_attention_bwd_plain(tq, h, torch.from_numpy(bias), td).float().numpy()
    got = k7_bwd_emulated(tq, h, bias, td)
    _grad_bars(got, ref)
    e = h * D
    hi_only = k7_bwd_emulated(tq, h, bias, td, split=False)
    assert np.abs(got - ref)[..., : 2 * e].mean() < np.abs(hi_only - ref)[..., : 2 * e].mean()


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d,ptrs,route", [
    (torch.bfloat16, 64, (0, 16, 4096), "mma"),
    (torch.bfloat16, 64, (), "mma"),
    (torch.float32, 64, (0,), "rowloop"),  # f32 products stay off the tensor cores
    (torch.bfloat16, 32, (0,), "rowloop"),
    (torch.bfloat16, 128, (0,), "rowloop"),
    (torch.bfloat16, 64, (0, 4), "rowloop"),  # one pointer off 16-byte alignment
    (torch.float16, 64, (0,), "rowloop"),
])
def test_attention_route(dtype, d, ptrs, route):
    """``attention_route``: the tensor cores for bf16 at head dim 64 with
    every pointer 16-byte aligned, the CUDA-core row loop otherwise."""
    assert tattn.attention_route(dtype, d, *ptrs) == route


def test_route_counters_exist_and_cpu_calls_count_nothing():
    """Every kernel with two routes has a counter per route beside its
    total; the wrappers on CPU tensors run the plain versions and count
    nothing."""
    for name in tbk.MASKED_KERNELS:
        assert {f"{name}/{r}" for r in tattn.ROUTES} <= set(tbk.LAUNCHES)
    assert {f"packed_attention_bwd/{r}" for r in tattn.ROUTES} <= set(tattn.LAUNCHES)
    before, before_a = dict(tbk.LAUNCHES), dict(tattn.LAUNCHES)
    qkv = _masked_qkv(17, 1, 0)
    tbk.masked_attention(qkv, 17, 1, causal=True, f32_ctx=True)
    tbk.causal_attention(qkv, 17, 1)
    x = torch.randn(2, 17, 3 * D).bfloat16()
    tattn.packed_attention_bwd(x, 1, torch.zeros(17, 17), torch.randn(2, 17, D).bfloat16())
    assert tbk.LAUNCHES == before and tattn.LAUNCHES == before_a


def test_score_order_script_runs_on_the_cpu(capsys):
    """``jcf_tpu_torch/scripts/score_order.py`` at 2 prompts and one seed on
    the CPU (where ``causal_attention`` runs its plain version): a line a
    case, the shares in [0, 1], no element past the bar."""
    from jcf_tpu_torch.scripts import score_order

    rows = score_order.run("cpu", prompts=2, seeds=1)
    assert [(r["prompts"], r["scale"]) for r in rows] == [(2, 1.0), (1, 1.5)]
    assert all(0.0 <= r["matmul_eq_seq_fma"] <= 1.0 and r["kernel_over"] == 0 for r in rows)
    assert len(capsys.readouterr().out.splitlines()) == 3
