"""Port quantization vs the JAX package: int8 weights equal, f32 scales
and static activation scales to f32 rounding (rtol 1e-6), the f32
calibration forward (rtol 1e-5), the normalization fold and the int8
patch-embed weights (``engine.py:470-480``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import quant as jquant
from jcf_tpu_torch.infer.engine import _embed_quant
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

SMALL = dict(
    embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=8, vocab_size=100, text_width=64,
    text_heads=1, text_layers=1,
)
HEADS = {"visual": 2, "text": 1}


def _params(seed, perturb_ln=True):
    """JAX params with non-trivial LN affines and biases (so every fold
    term matters), and the same tree as torch tensors."""
    p = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(seed, jclip.CLIPConfig(**SMALL)))
    rng = np.random.default_rng(seed + 100)
    blocks = p["visual"]["blocks"]
    if perturb_ln:
        for ln in ("ln_1", "ln_2"):
            blocks[ln]["scale"] = (1 + 0.1 * rng.standard_normal(blocks[ln]["scale"].shape)).astype(np.float32)
            blocks[ln]["bias"] = (0.1 * rng.standard_normal(blocks[ln]["bias"].shape)).astype(np.float32)
        for leaf in (blocks["attn"], blocks["mlp"]["c_fc"], blocks["mlp"]["c_proj"]):
            for k in [k for k in leaf if k.startswith("b")]:
                leaf[k] = (0.05 * rng.standard_normal(leaf[k].shape)).astype(np.float32)
    return p, tclip.params_from_numpy(p)


def _calib_images(seed, n=4):
    return np.random.default_rng(seed).random((n, 3, 64, 64)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_weight_matches_jax(seed):
    w = np.random.default_rng(seed).standard_normal((3, 48, 32)).astype(np.float32)
    w[1, 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    ref = jax.vmap(jquant.quantize_weight)(jnp.asarray(w))
    got = tquant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got.w_int8.numpy(), np.asarray(ref.w_int8))
    np.testing.assert_allclose(got.w_scale.numpy(), np.asarray(ref.w_scale), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_vision_ln_z_amax_matches_jax(seed):
    jp, tp = _params(seed)
    imgs = _calib_images(seed)
    ref = np.asarray(jclip.vision_ln_z_amax(jp, jclip.CLIPConfig(**SMALL), jnp.asarray(imgs)))
    got = tclip.vision_ln_z_amax(tp, tclip.CLIPConfig(**SMALL), torch.from_numpy(imgs))
    assert got.shape == ref.shape == (2, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 5, 7])
def test_quantize_clip_params_static_full_matches_jax(seed):
    jp, tp = _params(seed)
    amax = np.asarray(jclip.vision_ln_z_amax(jp, jclip.CLIPConfig(**SMALL),
                                             jnp.asarray(_calib_images(seed))))
    ref = jquant.quantize_clip_params(
        jp, fold=True, heads=HEADS, act_scales={"visual": amax}, act_static=("ctx", "hidden"),
    )["visual"]
    got = tquant.quantize_clip_params(tp, fold=True, heads=HEADS,
                                      act_scales={"visual": torch.tensor(amax)})["visual"]
    for half, names in (("attn", ("w_qkv", "w_out")), ("mlp", ("c_fc", "c_proj"))):
        for name in names:
            r, g = ref[half][name], got[half][name]
            np.testing.assert_array_equal(g.w_int8.numpy(), np.asarray(r.w_int8), err_msg=name)
            np.testing.assert_allclose(g.w_scale.numpy(), np.asarray(r.w_scale), rtol=1e-6,
                                       err_msg=name)
            # the folded biases sum W * ln_bias in another order
            np.testing.assert_allclose(g.bias.numpy(), np.asarray(r.bias), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    for half, names in (("attn", ("ln_inv", "ctx_inv")), ("mlp", ("ln_inv", "h_inv"))):
        for name in names:
            np.testing.assert_allclose(got[half][name].numpy(), np.asarray(ref[half][name]),
                                       rtol=1e-6, err_msg=f"{half}/{name}")
    assert "score_shift" not in got["attn"]


def test_margins_match_the_reference():
    """The JAX function's LN-input and static ctx / hidden scales carry
    the port's LN_MARGIN and STATIC_MARGIN."""
    jp, _ = _params(0, perturb_ln=False)
    amax = np.full((2, 4), 3.0, np.float32)
    ref = jquant.quantize_clip_params(jp, fold=True, heads=HEADS, act_scales={"visual": amax},
                                      act_static=("ctx", "hidden"))["visual"]
    for half, name, margin in (("attn", "ln_inv", tquant.LN_MARGIN),
                               ("mlp", "ln_inv", tquant.LN_MARGIN),
                               ("attn", "ctx_inv", tquant.STATIC_MARGIN),
                               ("mlp", "h_inv", tquant.STATIC_MARGIN)):
        np.testing.assert_allclose(np.asarray(ref[half][name]).ravel(), 127.0 / (3.0 * margin),
                                   rtol=1e-6, err_msg=f"{half}/{name}")


def _jax_embed_quant(w4f, fb):
    """engine.py:470-480, the JAX engine's int8 patch-embed fold."""
    kern_f = jnp.transpose(w4f, (3, 0, 1, 2))
    flat = kern_f.reshape(kern_f.shape[0], -1)
    kscale = jnp.maximum(jnp.max(jnp.abs(flat), axis=1) / 127.0, 1e-8)
    k_q = jnp.clip(jnp.round(flat / kscale[:, None]), -127, 127).astype(jnp.int8)
    bias_i8 = fb + jnp.sum(flat, axis=1) * (127.0 / 254.0)
    return k_q, (kscale / 254.0).astype(jnp.float32), bias_i8


@pytest.mark.parametrize("seed", [0, 4])
def test_fold_normalize_and_embed_quant_match_jax(seed):
    jp, tp = _params(seed, perturb_ln=False)
    w = jp["visual"]["patch_embed"]["w"]
    w4_ref, fb_ref = jclip.fold_normalize_into_embed(w, CLIP_MEAN, CLIP_STD, 16)
    w4, fb = tclip.fold_normalize_into_embed(tp["visual"]["patch_embed"]["w"],
                                             tclip.CLIP_MEAN, tclip.CLIP_STD, 16)
    np.testing.assert_array_equal(w4.numpy(), np.asarray(w4_ref))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(fb_ref))

    kq_ref, sc_ref, b_ref = _jax_embed_quant(w4_ref, fb_ref)
    kq, sc, b = _embed_quant(w4, fb)
    assert kq.is_contiguous()
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_ref))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_ref), rtol=1e-6)
    # the bias sums a row of C*p*p = 768 weights, in another order
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-5, atol=1e-5)
