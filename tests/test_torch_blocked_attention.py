"""K8 (the blocked attention of sequences of 128 tokens or more) and the
multi-head attention around it, port vs the JAX package on the CPU.

``attention_plain`` and the wrapper ``fused_attention`` (its plain
version on CPU tensors) are held against JAX ``fused_attention(...,
impl="pallas_interpret")``, the Pallas kernel ``_attn_kernel_blocked`` in
interpret mode, as ``tests/test_ops.py:86-97`` holds it against XLA: f32
within 1e-5 + 1e-5 |ref|; bf16 within one bf16 ulp of the larger value +
1e-3 (CPU XLA keeps bf16 intermediates in f32, so p may round at another
point). ``multi_head_attention`` at 145 tokens, f32 and with the unfolded
int8 tree in bf16, against JAX's with ``impl="pallas_interpret"``. The
bf16 kernel's branch-free division (``csrc/attn_mma.cuh`` ``div_rcp``)
against the IEEE quotient, in exact rational arithmetic."""

from fractions import Fraction

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jcf_tpu.ops import attention as jattn
from jcf_tpu.ops import quant as jquant
from jcf_tpu_torch.ops import attention as tattn
from jcf_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


def _bias(kind, s):
    if kind == "none":
        return None
    if kind == "causal":
        return np.array(jattn.causal_mask(s))
    return np.where(np.abs(np.subtract.outer(np.arange(s), np.arange(s))) <= 9, 0.0,
                    -np.inf).astype(np.float32)


def _close_f32(got, ref):
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def _close_bf16(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    tol = 2.0**-8 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


def _qkv(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


# S and the head count (odd and even), each with three biases in two dtypes; 256
# (whole 16-row tiles), 257 and 577 (keys streamed in two passes) are the
# card's bf16 kernel's edges
@pytest.mark.parametrize("s,h", [(50, 3), (129, 2), (145, 3), (197, 2), (256, 2), (257, 3),
                                 (577, 2)])
@pytest.mark.parametrize("bias", ["none", "causal", "band"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_matches_jax_interpret(s, h, bias, dtype):
    q, k, v = _qkv(s + h, 2, h, s, 64)
    b = _bias(bias, s)
    jd = jnp.dtype(dtype)
    ref = jattn.fused_attention(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                                None if b is None else jnp.asarray(b), impl="pallas_interpret")
    ref = np.asarray(ref.astype(jnp.float32))
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    tb = None if b is None else torch.from_numpy(b)
    close = _close_f32 if dtype == "float32" else _close_bf16
    for fn in (tattn.attention_plain, tattn.fused_attention):
        got = fn(*args, tb)
        assert got.dtype == td and got.shape == (2, h, s, 64)
        close(got.float().numpy(), ref)


def test_k8_takes_strided_views_of_packed_qkv():
    """The wrapper on head views of a packed [B, S, 3E] qkv equals the
    packed K7 plain function at the same length (one formula)."""
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 150, 3 * 128))
                           .astype(np.float32))
    q, k, v = qkv.reshape(2, 150, 3, 2, 64).permute(2, 0, 3, 1, 4)
    got = tattn.fused_attention(q, k, v).transpose(1, 2).reshape(2, 150, 128)
    torch.testing.assert_close(got, tattn.packed_attention_plain(qkv, 2), rtol=0, atol=0)


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest binary32 value, ties to even (normal
    range)."""
    if x == 0:
        return x
    sign, x = (-1 if x < 0 else 1), abs(x)
    exp = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** exp > x:
        exp -= 1
    while Fraction(2) ** (exp + 1) <= x:
        exp += 1
    m = x / Fraction(2) ** (exp - 23)  # in [2^23, 2^24)
    whole, rest = divmod(m.numerator, m.denominator)
    if 2 * rest > m.denominator or (2 * rest == m.denominator and whole % 2):
        whole += 1
    return sign * whole * Fraction(2) ** (exp - 23)


def test_k8_division_by_reciprocal_is_ieee_division():
    """The bf16 kernel normalizes p = e / l without a division per
    element: y = RN(1 / l) once a row, then q = RN(e y), r = RN(e - l q)
    and RN(q + r y), two FMAs. On K8's range (e = exp(s - m) in (0, 1], l
    the row sum in [1, 768]) that equals the IEEE quotient RN(e / l) that
    ``attention_plain`` takes: 20,000 seeded cases and 4,000 near powers
    of two, in exact rational arithmetic."""
    rng = np.random.default_rng(0)
    e = np.exp(-rng.uniform(0, 30, 20000)).astype(np.float32)
    l = rng.uniform(1, 768, 20000).astype(np.float32)
    k = rng.integers(0, 10, 4000)
    near = (2.0 ** k * (1 + rng.integers(-50, 51, 4000) * 2.0**-23)).astype(np.float32)
    e = np.concatenate([e, (1 - rng.integers(0, 200, 4000) * 2.0**-24).astype(np.float32)])
    l = np.concatenate([l, np.maximum(near, np.float32(1))])
    for a, b in zip(e.tolist(), l.tolist()):
        a, b = Fraction(a), Fraction(b)
        y = _rn32(1 / b)
        q = _rn32(a * y)
        r = _rn32(a - b * q)
        assert _rn32(q + r * y) == _rn32(a / b), (a, b)


def _mha_params(seed, e):
    rng = np.random.default_rng(seed)
    return {"w_qkv": (rng.standard_normal((3 * e, e)) * e**-0.5).astype(np.float32),
            "b_qkv": (0.1 * rng.standard_normal(3 * e)).astype(np.float32),
            "w_out": (rng.standard_normal((e, e)) * e**-0.5).astype(np.float32),
            "b_out": (0.1 * rng.standard_normal(e)).astype(np.float32)}


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_head_attention_k8_route_f32_matches_jax(seed):
    """145 tokens, 2 heads of 64: K8 in f32 through both packages."""
    p = _mha_params(seed, 128)
    x = np.random.default_rng(seed + 10).standard_normal((3, 145, 128)).astype(np.float32)
    ref = jattn.multi_head_attention(jnp.asarray(x), {k: jnp.asarray(a) for k, a in p.items()}, 2,
                                     impl="pallas_interpret")
    got = tattn.multi_head_attention(torch.from_numpy(x),
                                     {k: torch.from_numpy(a) for k, a in p.items()}, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_multi_head_attention_k8_route_int8_matches_jax(seed):
    """145 tokens in bf16 with the unfolded int8 tree: per-row int8 qkv and
    out-proj around K8, min row cos >= 0.999 (the two sides round bf16 at
    other points on the CPU, so an int8 row may move by one step)."""
    p = _mha_params(seed, 128)
    x = np.random.default_rng(seed + 10).standard_normal((3, 145, 128)).astype(np.float32)
    jq = {k: jax.vmap(jquant.quantize_weight)(jnp.asarray(p[w])[None], jnp.asarray(p[b])[None])
          for k, w, b in (("w_qkv", "w_qkv", "b_qkv"), ("w_out", "w_out", "b_out"))}
    jq = {k: jquant.QuantizedLinear(*(a[0] for a in t)) for k, t in jq.items()}
    ref = jattn.multi_head_attention(jnp.asarray(x).astype(jnp.bfloat16), None, 2,
                                     impl="pallas_interpret", quant=jq)
    tq = {"w_qkv": tquant.quantize_weight(torch.from_numpy(p["w_qkv"]), torch.from_numpy(p["b_qkv"])),
          "w_out": tquant.quantize_weight(torch.from_numpy(p["w_out"]), torch.from_numpy(p["b_out"]))}
    got = tattn.multi_head_attention(torch.from_numpy(x).bfloat16(), None, 2, quant=tq)
    assert got.dtype == torch.bfloat16
    g = got.float().numpy().reshape(-1, 128)
    r = np.asarray(ref.astype(jnp.float32)).reshape(-1, 128)
    cos = (g * r).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.999, cos.min()
