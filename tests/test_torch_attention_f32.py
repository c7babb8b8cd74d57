"""The arithmetic of the register-tiled f32 attention (``csrc/attn_f32.cuh``:
K8 in f32, and the masked attention on f32 qkv, ``causal_attention_f32``
and ``head_attention_f32``) on the CPU.

The kernels run only on the card. Here their arithmetic is emulated in
numpy at the rounding points the kernels take: each score a sum over d in
order with one f32 rounding a step (a thread's FMA chain), then x scale
and + bias in f32; the causal mask, the bias' -inf and keys past S at
-inf; the plain row max; e = exp(s - m) in f32; l as the kernels add it:
lane l of the warp sums its keys l + 32 t in t order, then the lanes
butterfly over xor 1, 2, 4, 8, 16 (past 256 keys K8 streams 128-key
groups: each group's lane sums are added to the running ones rescaled by
exp(m_old - m_new), one FMA); p = e / l in f32 (``div_rcp``, the IEEE
quotient on this range: ``tests/test_torch_blocked_attention.py``); PV
over the keys in order, one f32 rounding a step. The emulation is held
against the JAX package (K8: ``_attention_pallas`` in interpret mode at
HIGHEST; the masked attention: ``_batched_attention(use_mask=True)`` in
f32 at HIGHEST on the reference's padded layout) and against the port's
plain versions, which ``chip_smoke.py`` holds the kernels against on the
card, at the card's bar 1e-5 + 1e-5 |ref|.
"""

import functools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch
from jax import lax

import jcf_tpu.ops.attention as jattn
import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu_torch.ops import attention as tattn
from jcf_tpu_torch.ops import block_kernel as tbk

torch.set_num_threads(1)

D = 64
HI = lax.Precision.HIGHEST
ONE_PASS = 256  # keys a K8 block stages at once; past it 128-key groups
GROUP = 128


def _fma_chain(a, b):
    """sum_d a[..., d] * b[..., d] in order, one f32 rounding a step (the
    product exact in f64, as an FMA takes it)."""
    acc = np.zeros(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]), np.float32)
    for d in range(a.shape[-1]):
        acc = (acc.astype(np.float64)
               + a[..., d].astype(np.float64) * b[..., d].astype(np.float64)).astype(np.float32)
    return acc


def _lane_partials(e):
    """Each lane's sum of its keys lane + 32 t, in t order: e [..., n] ->
    [..., 32] (keys past n add 0)."""
    n32 = -(-e.shape[-1] // 32) * 32
    ee = np.zeros(e.shape[:-1] + (n32,), np.float32)
    ee[..., : e.shape[-1]] = e
    part = np.zeros(e.shape[:-1] + (32,), np.float32)
    for t in range(n32 // 32):
        part = (part + ee[..., 32 * t : 32 * t + 32]).astype(np.float32)
    return part


def _butterfly(part):
    """The lanes' xor 1, 2, 4, 8, 16 sum: [..., 32] -> [...]."""
    lanes = np.arange(32)
    for o in (1, 2, 4, 8, 16):
        part = (part + part[..., lanes ^ o]).astype(np.float32)
    assert (part == part[..., :1]).all()  # every lane holds the same bits
    return part[..., 0]


def _row_sum(sc, m):
    """l of the one-pass kernel: e = exp(s - m), lane sums, butterfly."""
    e = np.exp((sc - m).astype(np.float32)).astype(np.float32)
    return _butterfly(_lane_partials(e))


def _streamed_max_sum(sc):
    """m and l of K8's streaming kernel: 128-key groups, the running lane
    sums rescaled as the max grows -> (m [..., 1], l [...])."""
    m = np.full(sc.shape[:-1] + (1,), -np.inf, np.float32)
    lp = np.zeros(sc.shape[:-1] + (32,), np.float32)
    with np.errstate(invalid="ignore"):
        for g0 in range(0, sc.shape[-1], GROUP):
            grp = sc[..., g0 : g0 + GROUP]
            mn = np.maximum(m, grp.max(-1, keepdims=True))
            sg = _lane_partials(np.exp((grp - mn).astype(np.float32)).astype(np.float32))
            scale = np.exp((m - mn).astype(np.float32)).astype(np.float32)
            lp = np.where(mn == -np.inf, np.float32(0),
                          (lp.astype(np.float64) * scale.astype(np.float64)
                           + sg.astype(np.float64)).astype(np.float32))
            m = mn
    return m, _butterfly(lp)


def attn_f32_emulated(q, k, v, *, scale, bias=None, causal=False):
    """The kernels' arithmetic on f32 q, k, v [B, H, S, D] -> [B, H, S, D]."""
    s = q.shape[2]
    sc = _fma_chain(q[:, :, :, None, :], k[:, :, None, :, :])  # [B, H, S, S]
    sc = (sc * np.float32(scale)).astype(np.float32)
    if bias is not None:
        sc = (sc + bias).astype(np.float32)
    if causal:
        sc[..., np.triu(np.ones((s, s), bool), 1)] = -np.inf
    if s <= ONE_PASS:
        m = sc.max(-1, keepdims=True)
        l = _row_sum(sc, m)
    else:
        m, l = _streamed_max_sum(sc)
    p = (np.exp((sc - m).astype(np.float32)).astype(np.float32) / l[..., None]).astype(np.float32)
    ctx = np.zeros(q.shape, np.float32)
    for j in range(s):
        ctx = (ctx.astype(np.float64)
               + p[..., j, None].astype(np.float64) * v[:, :, None, j, :].astype(np.float64)
               ).astype(np.float32)
    return ctx


def _close(got, ref):
    """The card's f32 bar: |diff| <= 1e-5 + 1e-5 |ref|."""
    assert np.isfinite(got).all()
    assert (np.abs(got - ref) <= 1e-5 + 1e-5 * np.abs(ref)).all(), float(np.abs(got - ref).max())


# ---------------------------------------------------------------------------
# K8 in f32
# ---------------------------------------------------------------------------

# ViT-B/32 at 128 tokens' edge, the 145-token test tower, ViT-B/16 (197),
# the one-pass edge (208), ViT-L/14 (257), ViT-L/14@336px (577), the limit
K8_LENGTHS = [128, 145, 197, 208, 257, 577, 768]


def _k8_bias(kind, s, rng):
    if kind == "none":
        return None
    if kind == "band":  # -inf past a band of 9: rows see 10-19 keys
        return np.where(np.abs(np.subtract.outer(np.arange(s), np.arange(s))) <= 9, 0.0,
                        -np.inf).astype(np.float32)
    return rng.standard_normal((s, s)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _k8_case(s, bias_kind):
    """Seeded inputs of one K8 case (1 crop x 2 heads) and the emulated
    kernel's context."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((1, 2, s, D)).astype(np.float32) for _ in range(3))
    bias = _k8_bias(bias_kind, s, rng)
    return q, k, v, bias, attn_f32_emulated(q, k, v, scale=1.0 / np.sqrt(D), bias=bias)


@pytest.mark.parametrize("bias_kind", ["none", "band", "random"])
@pytest.mark.parametrize("s", K8_LENGTHS)
def test_k8_f32_emulation_matches_jax(s, bias_kind):
    """The kernel's arithmetic against the TPU kernel in interpret mode."""
    q, k, v, bias, got = _k8_case(s, bias_kind)
    ref = jattn._attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if bias is None else jnp.asarray(bias), interpret=True)
    _close(got, np.asarray(ref, np.float32))


@pytest.mark.parametrize("bias_kind", ["none", "band", "random"])
@pytest.mark.parametrize("s", K8_LENGTHS)
def test_k8_f32_emulation_matches_the_plain_version(s, bias_kind):
    """... and against ``attention_plain``, the card's reference."""
    q, k, v, bias, got = _k8_case(s, bias_kind)
    ref = tattn.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                None if bias is None else torch.from_numpy(bias))
    _close(got, ref.numpy())


@pytest.mark.parametrize("s", [257, 577])
def test_streamed_sum_differs_from_the_one_pass_sum_only_in_rounding(s):
    """Past 256 keys l is the running sum over 128-key groups, rescaled as
    the max grows: the one-pass sum of the same e within f32 rounding, and
    the same max."""
    sc = np.random.default_rng(s).standard_normal((3, s)).astype(np.float32) * 4
    m, l = _streamed_max_sum(sc)
    assert (m == sc.max(-1, keepdims=True)).all()
    np.testing.assert_allclose(l, _row_sum(sc, m), rtol=2e-6)


def test_lane_sum_differs_from_the_row_order_only_in_rounding():
    """The kernels' l adds the same e in another order than a row sum (per
    lane over 32-key slots, then the warp): equal within f32 rounding."""
    e = np.random.default_rng(3).random((5, 197)).astype(np.float32)
    np.testing.assert_allclose(_butterfly(_lane_partials(e)), e.astype(np.float64).sum(-1),
                               rtol=1e-6)


def test_k8_f32_on_the_cpu_is_the_plain_version_and_counts_nothing():
    """CPU tensors take the plain version, whatever the kernel would refuse
    on the card (f32 views off 16 bytes here), and count no launch."""
    before = dict(tattn.LAUNCHES)
    buf = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 150, 3 * 128 + 1),
                                                                    dtype=np.float32))
    q, k, v = buf[..., 1:].unflatten(-1, (3, 2, 64)).permute(2, 0, 3, 1, 4)
    assert torch.equal(tattn.fused_attention(q, k, v), tattn.attention_plain(q, k, v))
    assert tattn.LAUNCHES == before


# ---------------------------------------------------------------------------
# the masked attention on f32 qkv
# ---------------------------------------------------------------------------


def _masked_emulated(qkv, s, h, *, causal, scale):
    """The kernel's arithmetic on f32 qkv [B * S, 3E] -> [B * S, E]."""
    b = qkv.shape[0] // s
    q, k, v = qkv.reshape(b, s, 3, h, D).transpose(2, 0, 3, 1, 4)
    out = attn_f32_emulated(np.ascontiguousarray(q), k, v,
                            scale=1.0 if scale is None else scale, causal=causal)
    return out.transpose(0, 2, 1, 3).reshape(b * s, h * D)


def _jax_masked_f32(qkv, s, h, *, causal, scale):
    """``_batched_attention(use_mask=True)`` in f32 at HIGHEST on the
    reference's layout (S padded to a multiple of 8, pad keys at -1e30)
    -> the context of the real rows [B * S, E]."""
    e = h * D
    b, s_pad = qkv.shape[0] // s, -(-s // 8) * 8
    q3 = np.zeros((b, s_pad, 3 * e), np.float32)
    q3[:, :s] = qkv.reshape(b, s, 3 * e)
    block = np.array(jattn.causal_mask(s)) if causal else np.zeros((s, s), np.float32)
    bias = np.full((s_pad, s_pad), jbk._NEG_INF, np.float32)
    bias[:s, :s] = block
    out = jbk._batched_attention(jnp.asarray(q3.reshape(b * s_pad, 3 * e)), jnp.asarray(bias), h,
                                 D, scale, b, s_pad, HI, s_real=s, use_mask=True)
    return np.asarray(out, np.float32).reshape(b, s_pad, e)[:, :s].reshape(b * s, e)


@functools.lru_cache(maxsize=None)
def _masked_case(s, h, causal, scaled):
    """Seeded f32 qkv of 2 sequences and the emulated kernel's context.
    Without a scale the q columns carry the 1/8, as the folded tree's do
    (the route's only caller): scores of the scaled route's size. (Logits
    8x larger, ~100, move JAX's f32 sums in XLA's order from the plain
    version's by 1.7e-5, over the bar, while the emulation stays within
    1e-6 of the plain version.)"""
    qkv = (np.random.default_rng(s * 16 + h).standard_normal((2 * s, 3 * h * D)) * 1.5
           ).astype(np.float32)
    scale = 0.125 if scaled else None
    if not scaled:
        qkv[:, : h * D] *= np.float32(0.125)
    return qkv, scale, _masked_emulated(qkv, s, h, causal=causal, scale=scale)


# the text tower (77; the longest rows 127, 128), the 3-head tower at 50,
# the folded tree's tiny tower (17), whole 32-key slots (64)
MASKED = [(s, h, causal, scaled) for s in (17, 50, 64, 77, 127, 128) for h in (3, 8)
          for causal in (True, False) for scaled in (True, False)]


@pytest.mark.parametrize("s,h,causal,scaled", MASKED)
def test_masked_f32_emulation_matches_jax(s, h, causal, scaled):
    qkv, scale, got = _masked_case(s, h, causal, scaled)
    _close(got, _jax_masked_f32(qkv, s, h, causal=causal, scale=scale))


@pytest.mark.parametrize("s,h,causal,scaled", MASKED)
def test_masked_f32_emulation_matches_the_plain_version(s, h, causal, scaled):
    qkv, scale, got = _masked_case(s, h, causal, scaled)
    ref = tbk.masked_attention_plain(torch.from_numpy(qkv), s, h, causal=causal, scale=scale)
    _close(got, ref.numpy())


@settings(max_examples=12, deadline=None, derandomize=True)
@given(s=st.integers(1, 128), h=st.sampled_from([1, 3, 8]), causal=st.booleans(),
       seed=st.integers(0, 2**16))
def test_masked_f32_emulation_at_any_length(s, h, causal, seed):
    """Any S the kernel takes (1-128: the partial last unit of 8 rows, the
    partial last 32-key slot, the causal slots a unit skips) against the
    plain version."""
    qkv = (np.random.default_rng(seed).standard_normal((2 * s, 3 * h * D)) * 1.5
           ).astype(np.float32)
    ref = tbk.masked_attention_plain(torch.from_numpy(qkv), s, h, causal=causal, scale=0.125)
    _close(_masked_emulated(qkv, s, h, causal=causal, scale=0.125), ref.numpy())


def test_causal_attention_f32_on_the_cpu_is_the_plain_version_and_counts_nothing():
    """CPU rows take the plain version, whatever the kernel would refuse on
    the card (head dim 32 here), and count no launch."""
    before = dict(tbk.LAUNCHES)
    qkv = torch.from_numpy(np.random.default_rng(6).standard_normal((2 * 77, 3 * 4 * 32),
                                                                    dtype=np.float32))
    assert torch.equal(tbk.causal_attention(qkv, 77, 4), tbk.causal_attention_plain(qkv, 77, 4))
    assert torch.equal(tbk.masked_attention(qkv, 77, 4, causal=False, scale=0.125),
                       tbk.masked_attention_plain(qkv, 77, 4, causal=False, scale=0.125))
    assert tbk.LAUNCHES == before


def test_f32_masked_kernels_count_one_route():
    """The f32 masked kernels have one route: no "/mma" or "/rowloop"
    counter exists for them, as for ``pair_attention_f32``."""
    for name in ("causal_attention_f32", "head_attention_f32"):
        assert name in tbk.LAUNCHES
        assert not [k for k in tbk.LAUNCHES if k.startswith(name + "/")]
