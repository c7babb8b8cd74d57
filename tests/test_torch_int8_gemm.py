"""The int8 GEMM's plain versions vs the JAX kernels' GEMM math
(``block_kernel._int8_gemm``, ``_gelu_quant_static``): int32
accumulators exact; the f32 dequant epilogues equal; the GELU requant
|diff| <= 1 on at most 0.1% (the two sides' tanh differ in the last
bits)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.ops.quant import QuantizedLinear
from jcf_tpu_torch.ops import int8_gemm as tig

torch.set_num_threads(1)


def _operands(seed, m=96, n=64, k=192):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    scale = (rng.random(n) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    resid = rng.standard_normal((m, n)).astype(np.float32)
    return a, w, scale, bias, resid


def _jax_dequant(a, w, scale, bias):
    q = QuantizedLinear(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias))
    return jbk._int8_gemm(jnp.asarray(a), None, q.w_int8, q.w_scale, q.bias)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_s32_is_exact(seed):
    a, w, *_ = _operands(seed, k=3072)
    got = tig.int8_gemm_s32(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bf16_and_residual_epilogues_match_jax(seed):
    a, w, scale, bias, resid = _operands(seed)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    y = _jax_dequant(a, w, scale, bias)
    ref_bf16 = np.asarray(y.astype(jnp.bfloat16).astype(jnp.float32))
    got = tig.int8_gemm_bf16(t(a), t(w), t(scale), t(bias))
    np.testing.assert_array_equal(got.float().numpy(), ref_bf16)

    r_bf = t(resid).bfloat16()
    ref_res = np.asarray((jnp.asarray(r_bf.float().numpy()) + y).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    got = tig.int8_gemm_residual(t(a), t(w), t(scale), t(bias), r_bf)
    np.testing.assert_array_equal(got.float().numpy(), ref_res)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_gelu_quant_matches_jax(seed):
    a, w, scale, bias, _ = _operands(seed)
    h_inv = np.float32(127.0 / 3.7)
    sc, b = scale * 0.03, bias * 0.1  # h = y * h_inv spans the int8 grid
    ref = np.asarray(jbk._gelu_quant_static(_jax_dequant(a, w, sc * h_inv, b * h_inv),
                                            jnp.float32(h_inv)))
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    got = tig.int8_gemm_gelu_quant(t(a), t(w), t(sc) * float(h_inv), t(b) * float(h_inv),
                                   0.851 / torch.tensor(h_inv))
    assert got.dtype == torch.int8
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert len(np.unique(ref)) > 50  # the test spans the quantized range


def test_kernel_shape_checks_raise_before_launch():
    """The CUDA path validates shapes in Python; on CPU tensors the plain
    version runs, so the checks are exercised through ``_launch``."""
    a = torch.zeros(4, 24, dtype=torch.int8)
    with pytest.raises(ValueError):
        tig._launch("s32", a, torch.zeros(8, 24, dtype=torch.int8), torch.int32)  # K % 16
    with pytest.raises(ValueError):
        tig._launch("s32", torch.zeros(4, 32, dtype=torch.int8),
                    torch.zeros(8, 16, dtype=torch.int8), torch.int32)  # K mismatch
