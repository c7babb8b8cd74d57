"""The whole-layer int8 kernels K9a (``block_int8``), K9d
(``layer_fused_int8``) and K9c (``stream_tower_int8``) in every
quantization mode of the folded tree: dynamic per-row scales, "ln",
"hidden" and "full+score", with 1 and 4 hidden chunks, on the prompted
tower's 54 rows (dense: 54 is not a multiple of 16). The port's plain
versions against the JAX kernels in interpret mode, with ``_FUSE``,
``_MLP_NSPLIT`` and ``_LAYER_NSPLIT`` set on both packages by
monkeypatch; one layer, the 2-layer K9c and the 2-layer tower of each
route, and the int8 predict engines' crop features under each ``_FUSE``.

The bars are ``test_torch_fused_layer.py``'s: min row cos >= 0.999 and
atol = rtol = 5e-2 (an int8 value flips at a rounding tie where the two
sides' f32 sums and tanh differ in the last bits); the towers and the
engines at row cos >= 0.999. A dynamic hidden is quantized per row and
per MLP chunk, so the chunk count is part of the result: one test pins
it."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
import test_torch_quant_modes as qm
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import quant as jquant
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.layers import layer_slice

torch.set_num_threads(1)

H, E, CROPS = qm.H, qm.E, qm.CROPS
S, S_PAD = 54, 64
MODES = [None, "ln", "hidden", "full+score"]


@pytest.fixture
def knobs(monkeypatch):
    """Sets ``_FUSE`` and the chunk counts on both packages for the test."""
    def set_(fuse, **counts):
        for mod in (jbk, tbk):
            monkeypatch.setattr(mod, "_FUSE", fuse)
            for name, value in counts.items():
                monkeypatch.setattr(mod, name, value)
    return set_


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert qm._row_cos(got, ref) >= 0.999
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def _jax_layer(fuse, x, lp, lq):
    """One JAX int8 layer on the dense rows: ``_block_int8_kernel`` under
    "block", ``_layer_fused_int8_kernel`` under "layer"."""
    if fuse == "block":
        return jbk.fused_block(x, lp, H, qm._bias(S), quant_layer=lq, interpret=True, s_real=S,
                               use_mask=False, quant_folded=True, dense=True, s_pad=S_PAD)
    return jbk._layer_block(x, lp, H, lq, True, s_real=S, s_pad=S_PAD, quant_folded=True)


def _plain(fuse):
    return tbk.block_int8 if fuse == "block" else tbk.layer_fused_int8


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fuse", ["block", "layer"])
def test_plain_layer_matches_jax(knobs, fuse, mode, nsp):
    """K9a (``_MLP_NSPLIT`` chunks) and K9d (``_LAYER_NSPLIT``), one layer
    on all rows."""
    knobs(fuse, _MLP_NSPLIT=nsp, _LAYER_NSPLIT=nsp)
    jp, jq, tq = qm._trees(0, mode)
    x = qm._rows(5, S)
    lp, lq = qm._jax_layer(jp, jq, 1)
    ref = _jax_layer(fuse, qm._jx(x), lp, lq)
    got = _plain(fuse)(x, layer_slice(tq, 1), S, H)
    assert got.shape == (CROPS * S, E) and got.dtype == torch.bfloat16
    _close(got.float().numpy(), qm._np(ref))


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_plain_stream_tower_matches_jax(knobs, mode, nsp):
    """K9c: both layers on all rows in one call."""
    knobs("stream", _MLP_NSPLIT=nsp)
    jp, jq, tq = qm._trees(1, mode)
    x = qm._rows(6, S)
    ref = jbk._stream_tower(qm._jx(x), jp["visual"]["blocks"], jq, H, qm._bias(S), s_real=S,
                            s_pad=S_PAD, interpret=True, quant_folded=True)
    got = tbk.stream_tower_int8(x, tq, H, s=S)
    assert got.shape == (CROPS * S, E) and got.dtype == torch.bfloat16
    _close(got.float().numpy(), qm._np(ref))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fuse", ["block", "layer", "stream"])
def test_plain_tower_matches_jax(knobs, fuse, mode):
    """``run_fused_tower`` with ``cls_only``: K9a / K9d on the first layer
    then K5 + K4 on the CLS rows, or one K9c and its CLS rows."""
    knobs(fuse)
    jp, jq, tq = qm._trees(0, mode)
    x = qm._rows(7, S)
    ref = jbk.run_fused_tower(qm._jx(x), jp["visual"]["blocks"], H, None, quant=jq,
                              quant_folded=True, interpret=True, flat_s=S, cls_only=True)
    got = tbk.run_fused_tower(x, tq, H, flat_s=S)
    assert got.shape == (CROPS, E) and got.dtype == torch.bfloat16
    assert qm._row_cos(got.float().numpy(), qm._np(ref)) >= 0.999


def test_dynamic_hidden_is_quantized_per_chunk(knobs):
    """K9d with a dynamic hidden quantizes each of its ``_LAYER_NSPLIT``
    chunks of each row on its own: 4 chunks and 1 chunk give other
    outputs, the port's 4-chunk layer follows JAX's 4-chunk kernel (not
    the whole-row quantization), and the whole-row one is exactly the
    halves' K3 + K4 (``_MLP_NSPLIT`` = 1)."""
    jp, jq, tq = qm._trees(0, None)
    x = qm._rows(8, S)
    lp, lq = qm._jax_layer(jp, jq, 0)
    layer = layer_slice(tq, 0)
    knobs("layer", _LAYER_NSPLIT=4)
    ref4 = qm._np(_jax_layer("layer", qm._jx(x), lp, lq))
    got4 = tbk.layer_fused_int8(x, layer, S, H)
    knobs("layer", _LAYER_NSPLIT=1)
    ref1 = qm._np(_jax_layer("layer", qm._jx(x), lp, lq))
    got1 = tbk.layer_fused_int8(x, layer, S, H)
    halves = tbk.mlp_half_int8(tbk.attn_half_int8(x, layer["attn"], S, H), layer["mlp"])
    assert torch.equal(got1, halves) and not torch.equal(got4, halves)
    g4, g1 = got4.float().numpy(), got1.float().numpy()
    # the chunk count moves most outputs; each side follows its own reference
    assert (ref4 != ref1).mean() > 0.3 and (g4 != g1).mean() > 0.3
    assert (g4 != ref4).mean() < 0.02 and (g1 != ref1).mean() < 0.02
    assert (g4 != ref1).mean() > 0.3 and (g1 != ref4).mean() > 0.3


def _prompted_cfg():
    """``qm._cfg`` with 4 visual prompt tokens: 54 tokens at 224²."""
    return dict(qm._cfg(224), vision_prompt_tokens=4)


@pytest.mark.parametrize("fuse", ["halves", "block", "layer", "stream"])
def test_int8_predict_engine_crop_features_match_jax(knobs, fuse):
    """The int8 engine ``jcf-predict`` builds for the prompted tower (no
    calibration: dynamic per-row scales; 54 tokens) encodes a crop cloud
    under each ``_FUSE`` as JAX's fused tower does in interpret mode under
    the same ``_FUSE`` (``encode_image`` on the folded tree)."""
    knobs(fuse)
    cfg = _prompted_cfg()
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(6, jclip.CLIPConfig(**cfg)))
    assert jp["visual"]["vpt"].shape == (4, E)
    rng = np.random.default_rng(6)
    crops = rng.standard_normal((2, 3, 3, 224, 224)).astype(np.float32)
    jq = jquant.quantize_clip_params(jp, fold=True, heads={"visual": H, "text": 1})["visual"]
    ref = np.asarray(qm._jax_cloud(jp, cfg, crops, jq)).reshape(6, -1)
    engine = TTAEngine(tclip.params_from_numpy(jp), tclip.CLIPConfig(**cfg), device="cpu",
                       quant="int8")
    got = engine.crop_features(torch.from_numpy(crops))
    assert got.shape == (2, 3, 32) and got.dtype == torch.float32
    assert qm._row_cos(got.numpy().reshape(6, -1), ref) >= 0.999
