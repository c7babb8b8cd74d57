"""The serving slice of towers of 128 tokens or more (ViT-B/16's route) end
to end on the CPU, at a small tower of 145 tokens (96² crops, patch 8,
2 heads of 64, 2 layers).

``TTAEngine(quant="int8")`` of the port (plain versions on the CPU) vs the
same path composed from the JAX package's functions in interpret mode, as
the JAX engine runs it there (its fold and assembly gates need fewer than
128 tokens): int8 views, the im2col s32 patch dot, tokens ``acc * k_sc +
b_i8``, ``encode_image_tokens`` in bf16 with ``impl="pallas_interpret"``
(the composable route; attention through K8 in interpret mode) and the
unfolded int8 tree, L2 norm, MTA. Modes agree to cos >= 0.999 and the
top-1 class is equal. The f32 engine vs the same composition in f32: each
block within 5e-4, the modes within 1e-3 (``tests/test_golden_parity.py``'s
bars). And the port's own certificate: int8 vs f32 modes cos >= 0.99."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops.layers import l2_normalize
from jcf_tpu.ops.quant import quantize_clip_params
from jcf_tpu.ops.view_kernel import fused_views_nchw, sample_view_centers
from jcf_tpu.tta import solve_mta_batch
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops.layers import layer_slice

torch.set_num_threads(1)

SMALL = dict(
    embed_dim=32, image_resolution=96, vision_layers=2, vision_width=128,
    vision_patch_size=8, context_length=8, vocab_size=100, text_width=64,
    text_heads=2, text_layers=1,
)
B, SRC, N_RANDOM, CLASSES = 2, 104, 3, 10


def _inputs(seed):
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(seed, jclip.CLIPConfig(**SMALL)))
    images = rng.random((B, 3, SRC, SRC)).astype(np.float32)
    # the engines take bf16 sources: both sides see the same pixels
    images = np.array(jnp.asarray(images).astype(jnp.bfloat16).astype(jnp.float32))
    text = rng.standard_normal((CLASSES, SMALL["embed_dim"])).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    geometry = [np.array(a) for a in sample_view_centers(
        jax.random.PRNGKey(seed), B, N_RANDOM + 1, (SRC, SRC), SMALL["image_resolution"])]
    return jp, images, text, geometry


def _jax_slice(jp, images, geometry, text, dtype):
    """engine.py features_from_images_spec at 128 tokens or more, composed:
    int8 (bf16 tower) or f32."""
    cfg = jclip.CLIPConfig(**SMALL)
    res, p, g = cfg.image_resolution, cfg.vision_patch_size, cfg.grid_size
    w4f, fb = jclip.fold_normalize_into_embed(jp["visual"]["patch_embed"]["w"], CLIP_MEAN,
                                              CLIP_STD, p)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), jp)
    cy, cx, inv = (jnp.asarray(a) for a in geometry)
    b, n = cy.shape[:2]
    int8 = dtype == jnp.bfloat16
    views = fused_views_nchw(jnp.asarray(images).astype(dtype), cy, cx, inv, res,
                             interpret=True, quantize=int8)
    x6 = (views.reshape(b * n, 3, g, p, g, p).transpose(0, 2, 4, 1, 3, 5)
          .reshape(b * n, g * g, -1))
    if int8:
        flat = jnp.transpose(w4f, (3, 0, 1, 2)).reshape(w4f.shape[3], -1)  # engine.py:470-480
        kscale = jnp.maximum(jnp.max(jnp.abs(flat), axis=1) / 127.0, 1e-8)
        k_q = jnp.clip(jnp.round(flat / kscale[:, None]), -127, 127).astype(jnp.int8)
        k_sc, b_i8 = kscale / 254.0, fb + jnp.sum(flat, axis=1) * (127.0 / 254.0)
        acc = jax.lax.dot_general(x6, k_q, (((2,), (1,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        tokens = acc.astype(jnp.float32) * k_sc + b_i8  # engine.py:647
        quant = quantize_clip_params(jp, fold=False)["visual"]
    else:
        w_flat = jnp.transpose(w4f, (3, 0, 1, 2)).reshape(w4f.shape[3], -1)
        tokens = jnp.einsum("bsk,ek->bse", x6, w_flat, precision=jax.lax.Precision.HIGHEST) + fb
        quant = None
    feats = jclip.encode_image_tokens(params, cfg, tokens, dtype=dtype, impl="pallas_interpret",
                                      quant=quant)
    feats = l2_normalize(feats).reshape(b, n, -1).astype(jnp.float32)
    return np.asarray(solve_mta_batch(feats, jnp.asarray(text)))


def _port_modes(jp, images, geometry, text, quant):
    engine = TTAEngine(tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL), device="cpu",
                       n_views=N_RANDOM, quant=quant)
    got = engine.features_from_images(torch.from_numpy(images).bfloat16(), torch.from_numpy(text),
                                      geometry=tuple(torch.from_numpy(a) for a in geometry))
    assert got.shape == (B, SMALL["embed_dim"]) and got.dtype == torch.float32
    return engine, got.numpy()


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_small_tower_takes_the_k8_route():
    assert tclip.CLIPConfig(**SMALL).vision_seq_len == 145
    assert tclip.CLIPConfig(vision_patch_size=16).vision_seq_len == 197


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_slice_matches_jax_composition(seed):
    jp, images, text, geometry = _inputs(seed)
    ref = _jax_slice(jp, images, geometry, text, jnp.bfloat16)
    engine, got = _port_modes(jp, images, geometry, text, "int8")
    assert _cos(got, ref).min() >= 0.999, _cos(got, ref)
    logits = engine.logits(torch.from_numpy(got), torch.from_numpy(text)).numpy()
    np.testing.assert_array_equal(logits.argmax(-1), (ref @ text.T).argmax(-1))


def test_f32_slice_matches_jax_composition():
    jp, images, text, geometry = _inputs(2)
    ref = _jax_slice(jp, images, geometry, text, jnp.float32)
    _, got = _port_modes(jp, images, geometry, text, None)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("layer", [0, 1])
def test_f32_blocks_match_jax(layer):
    """One residual block at 145 tokens in f32 (K8 route): 5e-4."""
    jp, _, _, _ = _inputs(3)
    x = np.random.default_rng(layer).standard_normal((3, 145, 128)).astype(np.float32)
    jblocks = jax.tree_util.tree_map(lambda a: a[layer:layer + 1], jp["visual"]["blocks"])
    ref = jclip._run_blocks(jnp.asarray(x), jblocks, 2, None, impl="pallas_interpret")
    tblocks = layer_slice(tclip.params_from_numpy(jp)["visual"]["blocks"], slice(layer, layer + 1))
    got = tclip._run_blocks(torch.from_numpy(x), tblocks, 2, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4, rtol=0)


def test_int8_tracks_f32_reference():
    """The port's own cert on the CPU at 145 tokens: the int8 engine vs the
    f32 engine on the same geometry (the chip run gates ViT-B/16 at b256),
    as ``tests/test_infer.py:159-185`` does for JAX."""
    jp, images, text, geometry = _inputs(4)
    _, mq = _port_modes(jp, images, geometry, text, "int8")
    _, mf = _port_modes(jp, images, geometry, text, None)
    assert _cos(mq, mf).min() >= 0.99


def test_int8_engine_ignores_calibration_images():
    """From 128 tokens on the activation scales are per row: calibration
    images are accepted and change nothing, as in the JAX engine."""
    jp, images, text, geometry = _inputs(5)
    params, cfg = tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL)
    geo = tuple(torch.from_numpy(a) for a in geometry)
    img = torch.from_numpy(images).bfloat16()
    modes = [TTAEngine(params, cfg, device="cpu", quant="int8",
                       n_views=N_RANDOM, calibration_images=c)
             .features_from_images(img, torch.from_numpy(text), geometry=geo)
             for c in (None, images)]
    torch.testing.assert_close(modes[0], modes[1], rtol=0, atol=0)
