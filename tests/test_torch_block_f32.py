"""K9b in f32: ``run_float_tower`` under ``_FUSE = "block"`` on f32 rows
(``block_f32``, whose CPU branch is ``block_f32_plain``) against the JAX
package's ``run_fused_tower(quant=None)`` under ``_FUSE = "block"``
(``_block_kernel`` at ``Precision.HIGHEST``) in Pallas interpret mode,
on the same numpy weights and rows. ``_FUSE`` is set on both packages
with ``monkeypatch``.

Bars: each layer on the same input within 1e-5 + 1e-5 |ref| (the same f32
sums in another order), the whole tower's rows at cosine >= 0.99999."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.ops.attention import causal_mask as j_causal_mask
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.attention import causal_mask

torch.set_num_threads(1)

E, H, F, LAYERS, B = 128, 2, 512, 2, 3


def _blocks(seed):
    """Stacked f32 float blocks (the JAX layout), LN affines and biases
    nonzero."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (std * rng.standard_normal((LAYERS, *shape))).astype(np.float32)

    return {"ln_1": {"scale": 1 + n(E, std=0.1), "bias": n(E, std=0.1)},
            "ln_2": {"scale": 1 + n(E, std=0.1), "bias": n(E, std=0.1)},
            "attn": {"w_qkv": n(3 * E, E, std=0.05), "b_qkv": n(3 * E), "w_out": n(E, E),
                     "b_out": n(E)},
            "mlp": {"c_fc": {"w": n(F, E), "b": n(F)}, "c_proj": {"w": n(E, F), "b": n(E)}}}


def _layer(blocks, i):
    return jax.tree_util.tree_map(lambda a: a[i : i + 1], blocks)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_tower(x, blocks, s, causal):
    mask = j_causal_mask(s) if causal else None
    out = jbk.run_fused_tower(jnp.asarray(x.reshape(-1, s, E)),
                              jax.tree_util.tree_map(jnp.asarray, blocks), H, mask, interpret=True)
    return np.asarray(out).reshape(-1, E)


def _check_f32(got, want):
    bad = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
    assert not bad.any(), (np.abs(got - want).max(), int(bad.sum()))


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("s,causal", [(77, True), (50, False)])
def test_block_route_f32_matches_jax(monkeypatch, s, causal):
    monkeypatch.setattr(tbk, "_FUSE", "block")
    monkeypatch.setattr(jbk, "_FUSE", "block")
    blocks = _blocks(s)
    x = np.random.default_rng(s + 1).standard_normal((B * s, E)).astype(np.float32)
    calls = []
    block = tbk.block_f32
    monkeypatch.setattr(tbk, "block_f32",
                        lambda *a: calls.append(a[4]) or block(*a))
    # each layer on the same input
    xin = x
    for i in range(LAYERS):
        want = _jax_tower(xin, _layer(blocks, i), s, causal)
        got = tbk.run_float_tower(torch.from_numpy(np.array(xin)), _torch(_layer(blocks, i)), H,
                                  s=s, causal=causal).numpy()
        assert got.dtype == np.float32
        _check_f32(got, want)
        xin = want
    # the whole tower
    got = tbk.run_float_tower(torch.from_numpy(x), _torch(blocks), H, s=s, causal=causal).numpy()
    want = _jax_tower(x, blocks, s, causal)
    assert _cos(got, want).min() >= 0.99999
    # K9b ran once per layer, with the causal mask or an all-zero bias
    assert len(calls) == 2 * LAYERS
    bias = calls[0]
    if causal:
        torch.testing.assert_close(bias, causal_mask(s), atol=0, rtol=0)
    else:
        assert bias.shape == (s, s) and not bool(bias.any())


@pytest.mark.parametrize("s,causal", [(77, True), (50, False)])
def test_block_f32_plain_matches_the_halves(s, causal):
    """The block's math against the f32 halves (K6a + K6b) on the same
    layer: the same LN, products and attention; QuickGELU in its sigmoid
    form (the block) against its tanh form (the halves), equal in exact
    arithmetic."""
    blocks = _torch(_blocks(s + 7))
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((B * s, E)).astype(np.float32))
    bias = causal_mask(s) if causal else torch.zeros(s, s)
    for i in range(LAYERS):
        layer = jax.tree_util.tree_map(lambda a: a[i], blocks)
        got = tbk.block_f32_plain(x, layer, s, H, bias).numpy()
        want = tbk.mlp_half(tbk.attn_half(x, layer, s, H, causal=causal), layer).numpy()
        _check_f32(got, want)


def test_block_f32_runs_its_plain_version_on_cpu_tensors():
    layer = jax.tree_util.tree_map(lambda a: a[0], _torch(_blocks(0)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2 * 50, E)).astype(np.float32))
    bias = torch.zeros(50, 50)
    out = tbk.block_f32(x, layer, 50, H, bias)
    assert out.shape == x.shape and out.dtype == torch.float32
    torch.testing.assert_close(out, tbk.block_f32_plain(x, layer, 50, H, bias), atol=0, rtol=0)
