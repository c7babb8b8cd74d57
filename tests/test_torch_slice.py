"""The int8 serving slice end to end: ``TTAEngine.features_from_images``
of the port (plain versions on the CPU) vs the same path composed from
the JAX package's functions in interpret mode (the engine's TPU route:
int8 views, im2col s32 patch embed, assembly, the dense ``cls_only``
folded static-"full" tower with ``_CLS_ATTNQ = False``, ln_post/proj/L2,
MTA) on the same weights, images, crop geometry and classifier. Modes
agree to cos >= 0.999 and the top-1 class of the logits is equal.

Also: the port imports and runs with ``jax`` and ``jcf_tpu`` blocked."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops.assemble_kernel import assemble_dense_rows, make_cls_row
from jcf_tpu.ops.layers import l2_normalize
from jcf_tpu.ops.quant import quantize_clip_params
from jcf_tpu.ops.view_kernel import fused_views_nchw, sample_view_centers
from jcf_tpu.tta import solve_mta_batch
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models import clip as tclip

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(
    embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=8, vocab_size=100, text_width=64,
    text_heads=1, text_layers=1,
)
B, SRC, N_RANDOM, CLASSES = 4, 72, 3, 10


def _jax_slice(jp, images, geometry, text):
    """engine.py features_from_images_spec -> _rows_feats, composed."""
    cfg = jclip.CLIPConfig(**SMALL)
    res, p, g = cfg.image_resolution, cfg.vision_patch_size, cfg.grid_size
    # calibration on the center crops, CLIP-normalized (engine.py:373-383)
    top = (SRC - res) // 2
    crops = images[:32, :, top:top + res, top:top + res]
    mean = np.asarray(CLIP_MEAN, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(CLIP_STD, np.float32).reshape(1, 3, 1, 1)
    amax = jclip.vision_ln_z_amax(jp, cfg, jnp.asarray((crops - mean) / std))
    quant = quantize_clip_params(jp, fold=True, heads={"visual": cfg.vision_heads, "text": 1},
                                 act_scales={"visual": amax}, act_static=("ctx", "hidden"))["visual"]
    w4f, fb = jclip.fold_normalize_into_embed(jp["visual"]["patch_embed"]["w"], CLIP_MEAN,
                                              CLIP_STD, p)
    kern_f = jnp.transpose(w4f, (3, 0, 1, 2))  # engine.py:470-480
    flat = kern_f.reshape(kern_f.shape[0], -1)
    kscale = jnp.maximum(jnp.max(jnp.abs(flat), axis=1) / 127.0, 1e-8)
    k_q = jnp.clip(jnp.round(flat / kscale[:, None]), -127, 127).astype(jnp.int8)
    k_sc, b_i8 = kscale / 254.0, fb + jnp.sum(flat, axis=1) * (127.0 / 254.0)

    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jp)
    v = params["visual"]
    cy, cx, inv = (jnp.asarray(a) for a in geometry)
    b, n = cy.shape[:2]
    views = fused_views_nchw(jnp.asarray(images).astype(jnp.bfloat16), cy, cx, inv, res,
                             interpret=True, quantize=True)
    x6 = (views.reshape(b * n, 3, g, p, g, p).transpose(0, 2, 4, 1, 3, 5)
          .reshape(b * n, g * g, -1))
    acc = jax.lax.dot_general(x6, k_q, (((2,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    lnp = v["ln_pre"]
    cls_row = make_cls_row(v["class_embedding"], v["positional_embedding"][0], lnp["scale"],
                           lnp["bias"], dtype=jnp.bfloat16)
    rows = assemble_dense_rows(acc.reshape(b * n, g, g, -1), k_sc, b_i8,
                               v["positional_embedding"][1:], cls_row, lnp["scale"],
                               lnp["bias"], dtype=jnp.bfloat16, interpret=True)
    feats = jclip.encode_image_rows_dense(params, cfg, rows, dtype=jnp.bfloat16, quant=quant,
                                          quant_folded=True)
    feats = l2_normalize(feats).reshape(b, n, -1).astype(jnp.float32)
    return np.asarray(solve_mta_batch(feats, jnp.asarray(text)))


@pytest.mark.parametrize("seed", [0, 1])
def test_slice_matches_jax_composition(monkeypatch, seed):
    monkeypatch.setattr(jbk, "_CLS_ATTNQ", False)
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(seed, jclip.CLIPConfig(**SMALL)))
    images = rng.random((B, 3, SRC, SRC)).astype(np.float32)
    text = rng.standard_normal((CLASSES, SMALL["embed_dim"])).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    geometry = [np.array(a) for a in sample_view_centers(
        jax.random.PRNGKey(seed), B, N_RANDOM + 1, (SRC, SRC), SMALL["image_resolution"])]

    ref = _jax_slice(jp, images, geometry, text)
    engine = TTAEngine(tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL),
                       n_views=N_RANDOM, calibration_images=images)
    got = engine.features_from_images(torch.from_numpy(images).bfloat16(), torch.from_numpy(text),
                                      geometry=tuple(torch.from_numpy(a) for a in geometry))
    assert got.shape == (B, SMALL["embed_dim"]) and got.dtype == torch.float32
    got = got.numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.999, cos
    logits = engine.logits(torch.from_numpy(got), torch.from_numpy(text)).numpy()
    np.testing.assert_array_equal(logits.argmax(-1), (ref @ text.T).argmax(-1))


def test_int8_slice_tracks_f32_reference():
    """The port's own cert on the CPU: the int8 slice vs the plain f32
    path on the same geometry (the chip run gates this at b1024)."""
    rng = np.random.default_rng(3)
    params = tclip.init_clip_params(3, tclip.CLIPConfig(**SMALL))
    images = rng.random((B, 3, SRC, SRC)).astype(np.float32)
    text = torch.nn.functional.normalize(torch.randn(CLASSES, 32, generator=torch.Generator().manual_seed(3)), dim=-1)
    cfg = tclip.CLIPConfig(**SMALL)
    q = TTAEngine(params, cfg, n_views=N_RANDOM, calibration_images=images)
    f = TTAEngine(params, cfg, n_views=N_RANDOM, quant=None)
    geo = q.sample_geometry(torch.Generator().manual_seed(0), B, (SRC, SRC))
    img = torch.from_numpy(images).bfloat16()
    mq = q.features_from_images(img, text, geometry=geo)
    mf = f.features_from_images(img, text, geometry=geo)
    assert float(torch.nn.functional.cosine_similarity(mq, mf).min()) >= 0.99


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["jcf_tpu"] = None
import numpy as np, torch
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params
cfg = CLIPConfig(embed_dim=32, image_resolution=64, vision_layers=1, vision_width=128,
                 vision_patch_size=16, context_length=8, vocab_size=50, text_width=64,
                 text_heads=1, text_layers=1)
imgs = np.random.default_rng(0).random((2, 3, 72, 72)).astype(np.float32)
eng = TTAEngine(init_clip_params(0, cfg), cfg, n_views=2, calibration_images=imgs)
text = torch.nn.functional.normalize(torch.ones(5, 32), dim=-1)
modes = eng.features_from_images(torch.from_numpy(imgs).bfloat16(), text,
                                 generator=torch.Generator().manual_seed(0))
assert modes.shape == (2, 32) and bool(modes.isfinite().all())
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_jax_imports_in_port():
    pattern = re.compile(r"^\s*(import jax|from jax|import jcf_tpu\b|from jcf_tpu(\.| ))", re.M)
    sources = list((ROOT / "jcf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                              ROOT / "profile_torch.py"]
    assert len(sources) > 10
    for path in sources:
        assert not pattern.search(path.read_text()), path
