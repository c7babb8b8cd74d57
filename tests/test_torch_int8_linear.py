"""The dynamic per-row int8 linear of the composable tower and its
unfolded weight tree, port vs the JAX package on the CPU
(``jcf_tpu/ops/quant.py:41-61`` and ``:190-207``,
``jcf_tpu/ops/layers.py:55-67``).

The unfolded tree is bitwise equal (int8 weights, f32 scales, biases).
On f32 inputs the int8 rows equal those of the JAX function's row
quantization and the outputs agree within one bf16 ulp (+ 1e-6); on bf16
inputs within one bf16 ulp + 1e-3. ``mlp(quant=)`` likewise in f32; in
bf16 by row cosine >= 0.999, since CPU XLA keeps the bf16 QuickGELU chain
in f32 and the hidden rows then quantize one step apart here and there."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import layers as jlayers
from jcf_tpu.ops import quant as jquant
from jcf_tpu_torch.ops import int8_gemm as tig
from jcf_tpu_torch.ops import layers as tlayers
from jcf_tpu_torch.ops import quant as tquant
from jcf_tpu_torch.models import clip as tclip

torch.set_num_threads(1)

SMALL = dict(
    embed_dim=32, image_resolution=96, vision_layers=2, vision_width=128,
    vision_patch_size=8, context_length=8, vocab_size=100, text_width=64,
    text_heads=2, text_layers=1,
)


def _close(got, ref, atol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    tol = 2.0**-8 * np.maximum(np.abs(got), np.abs(ref)) + atol
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


def _jax_rows(x):
    """The row quantization of ``jcf_tpu.ops.quant.int8_linear`` (:47-50)."""
    xf = jnp.asarray(x).astype(jnp.float32)
    x_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-8)
    return np.asarray(jnp.clip(jnp.round(xf / x_scale), -127, 127).astype(jnp.int8)), \
        np.asarray(x_scale[..., 0])


def _weights(seed, n, k):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * k**-0.5).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return w, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unfolded_tree_is_bitwise_jax(seed):
    jp = jax.tree_util.tree_map(np.array, jclip.init_clip_params(seed, jclip.CLIPConfig(**SMALL)))
    rng = np.random.default_rng(seed + 50)
    blocks = jp["visual"]["blocks"]
    for leaf in (blocks["attn"], blocks["mlp"]["c_fc"], blocks["mlp"]["c_proj"]):
        for k in [k for k in leaf if k.startswith("b")]:
            leaf[k] = (0.05 * rng.standard_normal(leaf[k].shape)).astype(np.float32)
    blocks["mlp"]["c_fc"]["w"][1, 7] = 0.0  # an all-zero channel takes the 1e-8 floor
    ref = jquant.quantize_clip_params(jp, fold=False)["visual"]
    got = tquant.quantize_clip_params(tclip.params_from_numpy(jp), fold=False)["visual"]
    for half, names in (("attn", ("w_qkv", "w_out")), ("mlp", ("c_fc", "c_proj"))):
        assert set(got[half]) == set(ref[half])
        for name in names:
            for field in ("w_int8", "w_scale", "bias"):
                np.testing.assert_array_equal(getattr(got[half][name], field).numpy(),
                                              np.asarray(getattr(ref[half][name], field)),
                                              err_msg=f"{half}/{name}.{field}")


@pytest.mark.parametrize("shape", [(5, 7, 128), (33, 384), (2, 3, 4, 512)])
def test_int8_linear_f32_rows_exact_and_output_matches_jax(shape):
    rng = np.random.default_rng(shape[-1] + len(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 4.0, shape[:-1] + (1,))).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0  # an all-zero row takes the 1e-8 floor
    w, b = _weights(shape[-1], 96, shape[-1])
    rows, scale = _jax_rows(x)
    got_rows, got_scale = tquant.quantize_rows(torch.from_numpy(x).reshape(-1, shape[-1]))
    np.testing.assert_array_equal(got_rows.numpy(), rows.reshape(-1, shape[-1]))
    np.testing.assert_array_equal(got_scale.numpy(), scale.reshape(-1))

    ref = jquant.int8_linear(jnp.asarray(x), jquant.quantize_weight(jnp.asarray(w), jnp.asarray(b)))
    got = tquant.int8_linear(torch.from_numpy(x),
                             tquant.quantize_weight(torch.from_numpy(w), torch.from_numpy(b)))
    assert got.dtype == torch.float32 and got.shape == shape[:-1] + (96,)
    _close(got.numpy(), np.asarray(ref), 1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_int8_linear_bf16_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 145, 128)).astype(np.float32)
    w, b = _weights(seed, 384, 128)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jquant.int8_linear(xb, jquant.quantize_weight(jnp.asarray(w), jnp.asarray(b)))
    got = tquant.int8_linear(torch.from_numpy(x).bfloat16(),
                             tquant.quantize_weight(torch.from_numpy(w), torch.from_numpy(b)))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), 1e-3)


def test_rowscale_epilogue_order():
    """``(acc * row_scale) * scale + bias``: the plain epilogue rounds each
    product on its own, as the JAX expression does."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-127, 128, (9, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 64)).astype(np.int8))
    xs, ws = torch.rand(9) * 0.03, torch.rand(16) * 1e-3
    bias = torch.randn(16)
    acc = tig.int8_matmul_plain(a, w)
    ref = (acc.float() * xs[:, None]) * ws + bias
    torch.testing.assert_close(tig.int8_gemm_rowscale(a, w, xs, ws, bias, torch.float32), ref,
                               rtol=0, atol=0)
    assert tig.int8_gemm_rowscale(a, w, xs, ws, bias).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_quant_matches_jax(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 145, 128)).astype(np.float32)
    w_fc, b_fc = _weights(7, 512, 128)
    w_pr, b_pr = _weights(8, 128, 512)
    jq = {"c_fc": jquant.quantize_weight(jnp.asarray(w_fc), jnp.asarray(b_fc)),
          "c_proj": jquant.quantize_weight(jnp.asarray(w_pr), jnp.asarray(b_pr))}
    ref = jlayers.mlp(jnp.asarray(x).astype(jnp.dtype(dtype)), None, quant=jq)
    tq = {"c_fc": tquant.quantize_weight(torch.from_numpy(w_fc), torch.from_numpy(b_fc)),
          "c_proj": tquant.quantize_weight(torch.from_numpy(w_pr), torch.from_numpy(b_pr))}
    got = tlayers.mlp(torch.from_numpy(x).to(getattr(torch, dtype)), None, quant=tq)
    assert got.dtype == getattr(torch, dtype)
    g = got.float().numpy().reshape(-1, 128)
    r = np.asarray(ref.astype(jnp.float32)).reshape(-1, 128)
    if dtype == "float32":
        _close(g, r, 1e-6)
    else:
        cos = (g * r).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(r, axis=-1))
        assert cos.min() >= 0.999, cos.min()
