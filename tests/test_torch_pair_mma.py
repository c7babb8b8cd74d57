"""The arithmetic of K3's paired attention on the tensor cores
(``csrc/pair_mma.cuh`` ``pair_attention_mma_kernel``: the int8 and f32
contexts) and of K7's bf16 forward (``csrc/packed_attn.cu``
``packed_attn_fwd_mma_kernel``) on the CPU, and the route between them and
the CUDA-core row loops.

The kernels run only on the card. Here each is emulated in numpy at the
rounding points the kernel takes. K3: the scores through ``qk_chunk``
(exact bf16 products, summed in f64 per k16 step of 16 dims and added to
the f32 sum with one rounding a step), x scale on the unfolded tree,
keys past S at -inf; the shift as the max over both heads of the pair
and the floor (0 where the reference pads the keys, -inf where it does
not), or the layer's calibrated shift; p = bf16(exp(s - m)); l = the sum
of those p in the quad's order; PV one k16 chunk of keys a step; the
int8 store int8(round(ctx_u x (ctx_inv / max(l, 1e-30)))) or the f32
store ctx_u x (1 / max(l, 1e-30)). K7's forward: the scores and p in the
reference's order (``tests/test_torch_attention_mma.py``'s emulation of
``scores_seq`` and ``softmax_rows``, x scale then + bias), bf16(p), PV
one k16 chunk a step, bf16. Each emulation is held against the JAX
package (``_paired_attention_nomask``, the attention of
``_attn_half_int8_kernel``, on the reference's padded layout; K7's
``packed_attention`` in interpret mode and ``_packed_attention_ref``) and
against the port's plain versions, which ``chip_smoke.py`` holds the
kernels against on the card, at the bars stated in each test."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.ops import attention as jattn
from jcf_tpu_torch.ops import attention as tattn
from jcf_tpu_torch.ops import block_kernel as tbk

import test_torch_attention_mma as am

torch.set_num_threads(1)

D = 64
CROPS, HEADS = 3, 4


def _chunks(s):
    """K3's key chunks: 4 up to 64 keys, 6 up to 96, 8 up to 127."""
    return 4 if s <= 64 else 6 if s <= 96 else 8


def _mma_steps(a, b):
    """a @ b^T over the last axis as mma.sync sums it: the exact products
    of each k16 step of 16 dims summed in f64, added to the f32 sum with
    one rounding a step."""
    acc = np.zeros(a.shape[:-1] + (b.shape[-2],), np.float32)
    for k0 in range(0, a.shape[-1], 16):
        part = (a[..., k0:k0 + 16].astype(np.float64)
                @ b[..., k0:k0 + 16].astype(np.float64).swapaxes(-1, -2))
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def pair_emulated(qkv, s, h, *, ctx_inv=None, shift=None, scale=None, floor=0.0):
    """``pair_attention_mma_kernel``'s arithmetic on bf16 qkv [B * S, 3E]
    -> the int8 context (``ctx_inv``) or the f32 one, [B * S, E]."""
    q, k, v = am._heads(qkv, s, h)  # [B, H, S, D]
    kp = 16 * _chunks(s)
    k, v = am._pad_keys(k, kp), am._pad_keys(v, kp)
    sc = _mma_steps(q, k)
    if scale is not None:
        sc = (sc * np.float32(scale)).astype(np.float32)
    sc[..., s:] = -np.inf
    b = sc.shape[0]
    if shift is None:
        pair = sc.reshape(b, h // 2, 2, s, kp)
        m = np.maximum(pair.max(axis=(2, 4), keepdims=True), np.float32(floor))
        m = np.broadcast_to(m, (b, h // 2, 2, s, 1)).reshape(b, h, s, 1)
    else:
        m = np.float32(shift)
    with np.errstate(invalid="ignore"):
        p = np.exp((sc - m).astype(np.float32)).astype(np.float32)
    p[np.isneginf(sc)] = 0.0
    p = am._bf16(p)
    l = am._quad_sum(p)[..., None]
    ctx = _mma_steps(p, v.swapaxes(-1, -2))  # [B, H, S, D]
    den = np.maximum(l, np.float32(1e-30))
    if ctx_inv is None:
        out = (ctx * (np.float32(1.0) / den).astype(np.float32)).astype(np.float32)
    else:
        c = (np.float32(ctx_inv) / den).astype(np.float32)
        out = np.clip(np.rint((ctx * c).astype(np.float32)), -127, 127)
    return out.transpose(0, 2, 1, 3).reshape(-1, h * D)


def _floor(s):
    """The pair shift's floor of the int8 towers' routes: 0 on the dense
    route (S not a multiple of 16: the reference's zeroed pad keys score
    0), -inf on the non-dense one."""
    return 0.0 if s % 16 else -np.inf


def _jax_pair(qkv, s, h, *, ctx_inv=None, shift=None, scale=None):
    """``_paired_attention_nomask`` on the reference's layout (S padded to
    a multiple of 16 with zero rows, which mask the pad keys to a score of
    0; none at a multiple of 16) -> the real rows [B * S, E], the int8
    context rounded from its f32 with the static scale folded in."""
    e = qkv.shape[1] // 3
    b, s_pad = qkv.shape[0] // s, -(-s // 16) * 16
    q3 = np.zeros((b, s_pad, 3 * e), np.float32)
    q3[:, :s] = qkv.float().numpy().reshape(b, s, 3 * e)
    out = jbk._paired_attention_nomask(
        jnp.asarray(q3).astype(jnp.bfloat16), h, D, None if scale is None else jnp.float32(scale),
        b, s_pad, s_real=s, score_shift=None if shift is None else jnp.float32(shift),
        post_scale=None if ctx_inv is None else jnp.float32(ctx_inv))
    out = np.asarray(out.astype(jnp.float32)).reshape(b, s_pad, e)[:, :s].reshape(-1, e)
    return out if ctx_inv is None else np.clip(np.round(out), -127, 127)


def _pair_qkv(s, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((CROPS * s, 3 * HEADS * D)).astype(np.float32) * 0.5
    return torch.from_numpy(x).bfloat16()


def _pair_slack(qkv, s, h, shift, scale, floor):
    """2^-7 sum_j p_j |v_j| / l: the move of a p that rounds to bf16 across
    a tie when two sides sum the scores in other orders."""
    e = h * D
    v_abs = torch.cat([qkv[:, : 2 * e], qkv[:, 2 * e:].abs()], 1)
    sh = None if shift is None else torch.tensor([[shift]])
    return 2.0**-7 * tbk.attention_plain(v_abs, None, s, h, sh, scale=scale, floor=floor).numpy()


# (context, calibrated shift, score scale): the static "full" mode, its
# "+score", the dynamic context of the folded tree and of the unfolded one
K3_FORMS = [("int8", None, None), ("int8", 6.0, None), ("f32", None, None), ("f32", None, 0.125)]
K3_SEQS = [50, 64, 82, 127]


@pytest.mark.parametrize("kind,shift,scale", K3_FORMS)
@pytest.mark.parametrize("s", K3_SEQS)
def test_k3_emulation_matches_jax(s, kind, shift, scale):
    """K3's tensor-core arithmetic against ``_paired_attention_nomask``
    (XLA on the CPU, which may keep p in f32) on bf16 qkv: the int8
    context (ctx_inv 30) off by at most 1 on <= 2% of the elements (the
    bar of ``tests/test_torch_block.py``'s plain-version test), the f32
    context within 1e-5 + 1e-5 |ref| + 2^-7 sum_j p_j |v_j| / l."""
    qkv = _pair_qkv(s, s + len(kind) + int(shift or 0))
    kw = dict(shift=shift, scale=scale)
    got = pair_emulated(qkv, s, HEADS, ctx_inv=30.0 if kind == "int8" else None,
                        floor=_floor(s), **kw)
    ref = _jax_pair(qkv, s, HEADS, ctx_inv=30.0 if kind == "int8" else None, **kw)
    if kind == "int8":
        am._close_int8(got, ref, 2e-2)
    else:
        slack = _pair_slack(qkv, s, HEADS, shift, scale, _floor(s))
        assert (np.abs(got - ref) <= 1e-5 + 1e-5 * np.abs(ref) + slack).all()


@pytest.mark.parametrize("kind,shift,scale", K3_FORMS)
@pytest.mark.parametrize("s", K3_SEQS)
def test_k3_emulation_within_the_cards_bars(s, kind, shift, scale):
    """The same arithmetic against ``attention_plain``, the card's
    reference, at ``chip_smoke.py``'s bars: ``check_int8`` at 1e-2 (within
    1 on at most 1% of the elements) and ``check_ctx_f32`` (1e-5 + 1e-5
    |ref| + 2^-7 sum_j p_j |v_j| / l)."""
    qkv = _pair_qkv(s, 7 * s + len(kind))
    floor = _floor(s)
    sh = None if shift is None else torch.tensor([[shift]])
    if kind == "int8":
        ref = tbk.attention_plain(qkv, torch.tensor([[30.0]]), s, HEADS, sh, scale=scale,
                                  floor=floor).numpy()
        got = pair_emulated(qkv, s, HEADS, ctx_inv=30.0, shift=shift, scale=scale, floor=floor)
        am._close_int8(got, ref, 1e-2)
    else:
        ref = tbk.attention_plain(qkv, None, s, HEADS, sh, scale=scale, floor=floor).numpy()
        got = pair_emulated(qkv, s, HEADS, shift=shift, scale=scale, floor=floor)
        slack = _pair_slack(qkv, s, HEADS, shift, scale, floor)
        assert (np.abs(got - ref) <= 1e-5 + 1e-5 * np.abs(ref) + slack).all()


# ---------------------------------------------------------------------------
# K7's bf16 forward
# ---------------------------------------------------------------------------


def k7_fwd_emulated(qkv, h, bias):
    """``packed_attn_fwd_mma_kernel``'s arithmetic: bf16 qkv [B, S, 3E] and
    the f32 [S, S] bias -> [B, S, E] bf16 values in f32. The scores in the
    reference's order x scale, + bias, keys past S at -inf; the row loop's
    softmax; bf16(p); PV one k16 chunk of keys a step; bf16."""
    b, s, e3 = qkv.shape
    q, k, v = am._heads(qkv.reshape(b * s, e3), s, h)
    kp = 16 * -(-s // 16)
    k, v = am._pad_keys(k, kp), am._pad_keys(v, kp)
    sc = (am._seq_dot(q, k) * np.float32(1.0 / np.sqrt(D))).astype(np.float32)
    sc[..., :s] = (sc[..., :s] + bias).astype(np.float32)
    sc[..., s:] = -np.inf
    p = am._bf16(am._softmax_rows(sc))
    ctx = am._bf16(_mma_steps(p, v.swapaxes(-1, -2)))  # [B, H, S, D]
    return ctx.transpose(0, 2, 1, 3).reshape(b, s, e3 // 3)


def k7_plain_on_the_card(qkv, h, bias):
    """``packed_attention_plain``'s arithmetic on the card: both products
    summed in the reference's order (torch.matmul in f32: one fmaf after
    another), x scale + bias, p = exp(s - max) / sum in f32, bf16(p) into
    PV, bf16."""
    b, s, e3 = qkv.shape
    q, k, v = am._heads(qkv.reshape(b * s, e3), s, h)
    sc = (am._seq_dot(q, k) * np.float32(1.0 / np.sqrt(D))).astype(np.float32)
    sc = (sc + bias).astype(np.float32)
    with np.errstate(invalid="ignore"):
        ex = np.exp((sc - sc.max(-1, keepdims=True)).astype(np.float32)).astype(np.float32)
    p = (ex / ex.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
    ctx = am._bf16(am._seq_dot(am._bf16(p), v.swapaxes(-1, -2)))
    return ctx.transpose(0, 2, 1, 3).reshape(b, s, e3 // 3)


# (S, heads, bias): the stage-1 step's text attention (causal) and vision
# attention (no mask), and a random finite bias
K7_CASES = [(77, 8, "causal"), (50, 12, "zero"), (50, 3, "random"), (77, 2, "random")]


def _k7_inputs(s, h, kind):
    rng = np.random.default_rng(3 * s + h)
    qkv = rng.standard_normal((2, s, 3 * h * D)).astype(np.float32)
    if kind == "causal":
        bias = np.array(tattn.causal_mask(s).numpy(), np.float32)
    elif kind == "zero":
        bias = np.zeros((s, s), np.float32)
    else:
        bias = rng.standard_normal((s, s)).astype(np.float32)
    return torch.from_numpy(qkv).bfloat16(), bias


def _k7_slack(qkv, h, bias):
    """2^-7 sum_j p_j |v_j|, the move of p's rounding across a tie."""
    e = qkv.shape[-1] // 3
    v_abs = torch.cat([qkv[..., : 2 * e], qkv[..., 2 * e:].abs()], -1).float()
    return 2.0**-7 * tattn.packed_attention_plain(v_abs, h, torch.from_numpy(bias)).numpy()


def _bf16_bar(got, ref, slack=0.0):
    """``check_bf16``: 1 bf16 ulp of the larger value + 1e-3 (+ slack)."""
    tol = 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3 + slack
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("s,h,kind", K7_CASES)
def test_k7_fwd_emulation_matches_jax(s, h, kind):
    """K7's bf16 forward arithmetic against the JAX package on the CPU:
    ``packed_attention`` (the Pallas kernel in interpret mode) and
    ``_packed_attention_ref`` (XLA), both in bf16, within 1 bf16 ulp +
    1e-3 + 2^-7 sum_j p_j |v_j| (CPU XLA may keep p in f32)."""
    qkv, bias = _k7_inputs(s, h, kind)
    got = k7_fwd_emulated(qkv, h, bias)
    x = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    slack = _k7_slack(qkv, h, bias)
    for ref in (jattn.packed_attention(x, h, jnp.asarray(bias), interpret=True),
                jattn._packed_attention_ref(x, h, jnp.asarray(bias))):
        _bf16_bar(got, np.asarray(ref.astype(jnp.float32)), slack)


@pytest.mark.parametrize("s,h,kind", K7_CASES)
def test_k7_fwd_emulation_within_the_cards_bar(s, h, kind):
    """The same arithmetic against ``packed_attention_plain``'s arithmetic
    on the card at ``check_bf16``'s bar with no slack (phase 5b: both take
    the scores and p in the reference's order, so only PV's order and the
    last rounding differ), and against the CPU's plain version (whose
    matmul sums in another order) with the tie slack."""
    qkv, bias = _k7_inputs(s, h, kind)
    got = k7_fwd_emulated(qkv, h, bias)
    _bf16_bar(got, k7_plain_on_the_card(qkv, h, bias))
    ref = tattn.packed_attention_plain(qkv, h, torch.from_numpy(bias)).float().numpy()
    _bf16_bar(got, ref, _k7_slack(qkv, h, bias))


def test_k7_fwd_emulation_keeps_masked_rows_exact():
    """Under the causal mask row 0 sees key 0 only: p = 1 and the context
    is v_0 exactly, as in the plain version."""
    qkv, bias = _k7_inputs(77, 2, "causal")
    got = k7_fwd_emulated(qkv, 2, bias)
    e = 2 * D
    assert np.array_equal(got[:, 0], qkv[:, 0, 2 * e:].float().numpy())


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d,offset,route", [
    (torch.bfloat16, 64, 0, "mma"),
    (torch.bfloat16, 64, 2, "rowloop"),  # qkv 4 bytes off 16-byte alignment
    (torch.bfloat16, 32, 0, "rowloop"),
    (torch.float32, 64, 0, "rowloop"),  # K7 in f32: f32 products stay off the tensor cores
])
def test_routes_of_k3_and_k7(dtype, d, offset, route):
    """``attention_route`` on the pointers each wrapper passes (qkv and the
    freshly allocated output, which is aligned): K3's ``attention`` and
    K7's forward take the tensor cores for bf16 at head dim 64 with
    aligned qkv and the row loop otherwise."""
    n = 2 * 50 * 3 * 2 * d
    qkv = torch.zeros(n + 8, dtype=dtype)[offset:offset + n]
    out = torch.empty(2 * 50 * 2 * d, dtype=dtype)
    assert tattn.attention_route(qkv.dtype, d, qkv.data_ptr(), out.data_ptr()) == route


def test_route_counters_exist_and_cpu_calls_count_nothing():
    """K3's four attention kernels and K7's forward have a counter per
    route beside their totals; on CPU tensors the wrappers run the plain
    versions and count nothing."""
    for name in tbk.PAIRED_KERNELS:
        assert {name} | {f"{name}/{r}" for r in tattn.ROUTES} <= set(tbk.LAUNCHES)
    assert {f"packed_attention/{r}" for r in tattn.ROUTES} <= set(tattn.LAUNCHES)
    before, before_a = dict(tbk.LAUNCHES), dict(tattn.LAUNCHES)
    qkv = _pair_qkv(50, 0)
    tbk.attention(qkv, torch.tensor([[30.0]]), 50, HEADS)
    tbk.attention(qkv, None, 50, HEADS, scale=0.125)
    x, bias = _k7_inputs(50, 3, "zero")
    tattn.packed_attention_fwd(x, 3, torch.from_numpy(bias))
    assert tbk.LAUNCHES == before and tattn.LAUNCHES == before_a
