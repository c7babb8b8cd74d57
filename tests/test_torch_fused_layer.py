"""The whole-layer variants K9a-d (``_FUSE`` = "block", "layer", "stream")
of the port: the plain versions of ``block_int8`` (K9a),
``layer_fused_int8`` (K9d), ``stream_tower_int8`` (K9c) and
``block_bf16`` (K9b), per layer and through ``run_fused_tower`` /
``run_float_tower(causal=True)``, vs the JAX kernels in interpret mode with the same
``_FUSE`` and chunk knobs set on both packages.

The int8 layers take the folded static "full" tree, dense rows and
``cls_only``; their bars are those of ``test_torch_block.py``: min row
cos >= 0.999 and atol = rtol = 5e-2, because int8 values flip at rounding
ties where the two sides' f32 sums, tanh and calibrated scales differ in
the last bits. The bf16 text layer is held at the bars of
``test_torch_text.py`` (the same numbers). With XLA's excess precision off
(a subprocess), the JAX side rounds the bf16 mid of K9d where the port
does, and the two agree element for element on all but a few ties."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
import test_torch_block as vis
import test_torch_text as txt
from jcf_tpu.ops.attention import causal_mask
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.attention import causal_mask as t_causal_mask
from jcf_tpu_torch.ops.layers import layer_slice

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, S_PAD, E, H, CROPS = vis.S, vis.S_PAD, vis.E, vis.H, vis.CROPS
HIDDEN = 4 * E  # 512: 3 chunks do not divide it, so a count of 3 falls back to 1


@functools.lru_cache(maxsize=None)
def _trees(seed):
    return vis._quant_trees(seed)


@functools.lru_cache(maxsize=None)
def _text(seed):
    jp = txt._params(seed)
    return jp, tclip.params_from_numpy(jp)["text"]["blocks"]


@pytest.fixture
def knobs(monkeypatch):
    """Sets ``_FUSE`` and the chunk counts on both packages for the test."""
    def set_(fuse, **counts):
        for mod in (jbk, tbk):
            monkeypatch.setattr(mod, "_FUSE", fuse)
            for name, value in counts.items():
                monkeypatch.setattr(mod, name, value)
    return set_


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_layer(fuse, x, lp, lq):
    """One JAX int8 layer on the dense rows: ``fused_block`` under "block"
    (``_block_int8_kernel``), ``_layer_block`` under "layer"."""
    if fuse == "block":
        return jbk.fused_block(x, lp, H, vis._bias(), quant_layer=lq, interpret=True, s_real=S,
                               use_mask=False, quant_folded=True, dense=True, s_pad=S_PAD)
    return jbk._layer_block(x, lp, H, lq, True, s_real=S, s_pad=S_PAD, quant_folded=True)


@pytest.mark.parametrize("fuse,counts,layer", [
    ("block", {}, 0), ("block", {}, 1),
    ("block", {"_MLP_NSPLIT": 2}, 1),
    ("block", {"_MLP_NSPLIT": 3}, 1),  # does not divide 512: one chunk
    ("layer", {}, 0), ("layer", {}, 1),  # _LAYER_NSPLIT = 4
    ("layer", {"_LAYER_NSPLIT": 2}, 1),
    ("layer", {"_LAYER_NSPLIT": 3}, 1),
])
def test_plain_layer_matches_jax(knobs, fuse, counts, layer):
    """K9a and K9d, one layer on all rows."""
    knobs(fuse, **counts)
    jp, jq, tq = _trees(0)
    x = vis._rows(layer)
    lp, lq = vis._jax_layer(jp, jq, layer)
    ref = _jax_layer(fuse, vis._to_jax(x), lp, lq)
    kernel = tbk.block_int8 if fuse == "block" else tbk.layer_fused_int8
    got = kernel(x, layer_slice(tq, layer), S, H)
    assert got.shape == (CROPS * S, E) and got.dtype == torch.bfloat16
    vis._close(got.float().numpy(), _np32(ref))


@pytest.mark.parametrize("nsplit", [1, 2, 3])
def test_plain_stream_tower_matches_jax(knobs, nsplit):
    """K9c: both layers on all rows in one call."""
    knobs("stream", _MLP_NSPLIT=nsplit)
    jp, jq, tq = _trees(1)
    x = vis._rows(1)
    ref = jbk._stream_tower(vis._to_jax(x), jp["visual"]["blocks"], jq, H, vis._bias(), s_real=S,
                            s_pad=S_PAD, interpret=True, quant_folded=True)
    got = tbk.stream_tower_int8(x, tq, H, s=S)
    assert got.shape == (CROPS * S, E) and got.dtype == torch.bfloat16
    vis._close(got.float().numpy(), _np32(ref))


def test_chunk_count_falls_back():
    assert [tbk._chunks(n, HIDDEN) for n in (1, 2, 3, 4, 5)] == [1, 2, 1, 4, 1]


@pytest.mark.parametrize("fuse", ["block", "layer", "stream"])
@pytest.mark.parametrize("seed", [0, 2])
def test_plain_tower_matches_jax(knobs, fuse, seed):
    """``run_fused_tower`` under each ``_FUSE``: K9a / K9d on the first
    layers then K5 + K4 on the CLS rows, or one K9c and its CLS rows."""
    knobs(fuse)
    jp, jq, tq = _trees(seed)
    x = vis._rows(seed)
    ref = jbk.run_fused_tower(vis._to_jax(x), jp["visual"]["blocks"], H, None, quant=jq,
                              quant_folded=True, interpret=True, flat_s=S, cls_only=True)
    got = tbk.run_fused_tower(x, tq, H, flat_s=S)
    assert got.shape == (CROPS, E) and got.dtype == torch.bfloat16
    vis._close(got.float().numpy(), _np32(ref))


@pytest.mark.parametrize("seed,layer", [(0, 0), (0, 1), (1, 1)])
def test_plain_block_bf16_matches_jax(knobs, seed, layer):
    """K9b, one text layer vs ``_block_kernel`` on the padded layout with
    the TPU's additive bias (causal, pad keys at -1e30); the port runs
    unpadded with the causal mask."""
    knobs("block")
    jp, blocks = _text(seed)
    x = txt._rows(seed)
    lp = jax.tree_util.tree_map(lambda a: a[layer], jp["text"]["blocks"])
    ref = jbk.fused_block(txt._pad(x), lp, txt.H, txt._bias(), interpret=True)
    got = tbk.block_bf16(x, layer_slice(blocks, layer), txt.S, txt.H, t_causal_mask(txt.S))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    txt._close(got.float().numpy(), txt._unpad(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_text_tower_block_matches_jax(knobs, seed):
    knobs("block")
    jp, blocks = _text(seed)
    x = txt._rows(seed)
    ref = jbk.run_fused_tower(txt._to_jax(x).reshape(txt.B, txt.S, txt.E), jp["text"]["blocks"],
                              txt.H, causal_mask(txt.S), interpret=True)
    got = tbk.run_float_tower(x, blocks, txt.H, s=txt.S, causal=True)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    txt._close(got.float().numpy(), _np32(ref).reshape(txt.B * txt.S, txt.E))


@pytest.mark.parametrize("fuse", ["layer", "stream"])
def test_text_tower_keeps_halves(knobs, monkeypatch, fuse):
    """Under "layer" and "stream" the text tower runs the halves in both
    packages: the same output as under "halves", and no K9b."""
    jp, blocks = _text(2)
    x = txt._rows(2)
    xj = txt._to_jax(x).reshape(txt.B, txt.S, txt.E)

    def jax_tower():
        return _np32(jbk.run_fused_tower(xj, jp["text"]["blocks"], txt.H, causal_mask(txt.S),
                                         interpret=True))

    ref_halves, halves = jax_tower(), tbk.run_float_tower(x, blocks, txt.H, s=txt.S, causal=True)
    knobs(fuse)

    def no_k9b(*args):
        raise AssertionError("K9b ran outside _FUSE = 'block'")

    monkeypatch.setattr(tbk, "block_bf16", no_k9b)
    got, ref = tbk.run_float_tower(x, blocks, txt.H, s=txt.S, causal=True), jax_tower()
    assert torch.equal(got, halves)
    np.testing.assert_array_equal(ref, ref_halves)
    txt._close(got.float().numpy(), ref.reshape(txt.B * txt.S, txt.E))


@pytest.mark.parametrize("fuse", ["blocks", "HALVES", "", None])
def test_bad_fuse_value_raises(monkeypatch, fuse):
    monkeypatch.setattr(tbk, "_FUSE", fuse)
    _, _, tq = _trees(0)
    with pytest.raises(ValueError, match="_FUSE"):
        tbk.run_fused_tower(vis._rows(0), tq, H, flat_s=S)
    _, blocks = _text(0)
    with pytest.raises(ValueError, match="_FUSE"):
        tbk.run_float_tower(txt._rows(0), blocks, txt.H, s=txt.S, causal=True)


def test_quant_flags_of_the_trees():
    """The folded static tree selects the serving flags the kernels take;
    a tree without a static scale, with a static softmax shift, or not
    marked folded, does not."""
    _, _, tq = _trees(0)
    layer = layer_slice(tq, 0)
    assert tbk.quant_flags(tq) == tbk.quant_flags(layer) == tbk.SERVING_FLAGS
    no_ctx = {**layer, "attn": {k: v for k, v in layer["attn"].items() if k != "ctx_inv"}}
    assert tbk.quant_flags(no_ctx) == tbk.SERVING_FLAGS & ~tbk.FLAG_STATIC_CTX
    shift = {**layer, "attn": {**layer["attn"], "score_shift": layer["attn"]["ctx_inv"]}}
    assert tbk.quant_flags(shift) == tbk.SERVING_FLAGS | tbk.FLAG_STATIC_SHIFT
    unmarked = {"attn": layer["attn"], "mlp": layer["mlp"]}
    assert tbk.quant_flags(unmarked) == tbk.SERVING_FLAGS & ~tbk.FLAG_FOLDED


_JAX_STRICT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
import jcf_tpu.ops.block_kernel as jbk
d = np.load(sys.argv[1], allow_pickle=True).item()
x = jnp.asarray(d["x"]).astype(jnp.bfloat16)
lp, lq = d["lp"], d["lq"]
jbk._FUSE = "block"
k9a = jbk.fused_block(x, lp, d["H"], jnp.asarray(d["bias"]), quant_layer=lq, interpret=True,
                      s_real=d["S"], use_mask=False, quant_folded=True, dense=True, s_pad=d["S_PAD"])
k9d = jbk._layer_block(x, lp, d["H"], lq, True, s_real=d["S"], s_pad=d["S_PAD"], quant_folded=True)
np.save(sys.argv[2], np.stack([np.asarray(k9a.astype(jnp.float32)), np.asarray(k9d.astype(jnp.float32))]))
"""


def test_mid_rounding_strict_bf16(tmp_path):
    """K9a keeps the mid residual in f32, K9d rounds it to bf16 (and
    chunks the MLP): with XLA's excess precision off the JAX kernels round
    where the port's plain versions do. K9d agrees with its counterpart on
    all but 1e-3 of the elements; K9a on all but 1e-2, since the LN2
    statistics of an f32 mid are sums of inexact terms, taken in another
    order, so a few rows quantize differently at a tie. The two variants
    differ from each other on most elements, so a mid rounded at the wrong
    point fails."""
    jp, jq, tq = _trees(0)
    x = vis._rows(3)
    lp, lq = vis._jax_layer(jp, jq, 0)
    inputs = {"x": x.float().numpy(), "lp": jax.tree_util.tree_map(np.asarray, lp),
              "lq": jax.tree_util.tree_map(np.asarray, lq), "bias": np.asarray(vis._bias()),
              "H": H, "S": S, "S_PAD": S_PAD}
    np.save(tmp_path / "in.npy", inputs, allow_pickle=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_STRICT, str(tmp_path / "in.npy"),
                    str(tmp_path / "out.npy")], cwd=ROOT, env=env, check=True, timeout=600)
    ref_a, ref_d = np.load(tmp_path / "out.npy")
    layer = layer_slice(tq, 0)
    got_a = tbk.block_int8(x, layer, S, H).float().numpy()
    got_d = tbk.layer_fused_int8(x, layer, S, H).float().numpy()
    assert (got_a != ref_a).mean() <= 1e-2 and (got_d != ref_d).mean() <= 1e-3
    assert (got_a != got_d).mean() >= 0.3 and (ref_a != ref_d).mean() >= 0.3
