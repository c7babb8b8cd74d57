"""The zero-shot classifier build of the port vs the JAX package.

``build_classifier_weights`` (tokenize with the real 49408-entry vocab,
the bf16 text tower, L2-normalize, mean over templates, normalize again)
against ``jcf_tpu.tta.build_classifier_weights(..., dtype=bf16,
impl="fused")`` (the fused text tower in interpret mode), on the branch
with equal template counts and on the ragged one: rows agree to cos >=
0.999. ``build_text_weights``: a miss writes an f32 ``.npy`` under the
cache directory, a hit returns it without building, and a changed text
weight changes the key."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jcf_tpu.models import clip as jclip
from jcf_tpu.tta import build_classifier_weights as j_build
from jcf_tpu_torch.config import RuntimeConfig, perf_preset
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.pipelines import common
from jcf_tpu_torch.tta import build_classifier_weights

torch.set_num_threads(1)

SMALL = dict(
    embed_dim=32, image_resolution=64, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=77, text_width=128, text_heads=2, text_layers=2,
)
NAMES = ["giant panda", "bald eagle", "apple pie", "Shih-Tzu", "BMW M3 coupe", "T-shirt"]
PATTERNS = ["a photo of a {}.", "a sketch of the {}.", "an image of a {}.", "a good photo of a {}."]


def _params(seed):
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(seed, jclip.CLIPConfig(**SMALL)))
    rng = np.random.default_rng(seed + 3)
    for k in ("scale", "bias"):
        ln = jp["text"]["ln_final"]
        ln[k] = (ln[k] + 0.1 * rng.standard_normal(ln[k].shape)).astype(np.float32)
    return jp


def _rows_cos(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))


def _templates(ragged):
    counts = [1, 4, 2, 3, 4, 1] if ragged else [3] * len(NAMES)
    return {i: [PATTERNS[t].format(n) for t in range(c)] for i, (n, c) in enumerate(zip(NAMES, counts))}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ragged", [False, True])
def test_build_classifier_weights_matches_jax(seed, ragged):
    jp = _params(seed)
    templates = _templates(ragged)
    ref = np.asarray(j_build(jax.tree_util.tree_map(jnp.asarray, jp), jclip.CLIPConfig(**SMALL),
                             templates, dtype=jnp.bfloat16, impl="fused").astype(jnp.float32))
    got = build_classifier_weights(tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL),
                                   templates, device="cpu", dtype=torch.bfloat16)
    assert got.shape == (len(NAMES), SMALL["embed_dim"]) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-2)
    assert _rows_cos(got, ref).min() >= 0.999, _rows_cos(got, ref)


def test_batching_does_not_change_the_weights():
    """The prompts go through the tower in batches; rows are independent."""
    params = tclip.params_from_numpy(_params(2))
    cfg = tclip.CLIPConfig(**SMALL)
    templates = _templates(False)
    whole = build_classifier_weights(params, cfg, templates, device="cpu", dtype=torch.bfloat16)
    parts = build_classifier_weights(params, cfg, templates, batch_size=5, device="cpu",
                                     dtype=torch.bfloat16)
    assert torch.equal(whole, parts)


def _pipeline_cfg(tmp_path):
    return dataclasses.replace(
        perf_preset(), runtime=RuntimeConfig("bfloat16", str(tmp_path / "cache")))


def test_build_text_weights_cache(tmp_path, monkeypatch):
    params = tclip.params_from_numpy(_params(4))
    cfg = tclip.CLIPConfig(**SMALL)
    templates = _templates(False)
    pc = _pipeline_cfg(tmp_path)
    built = common.build_text_weights(params, cfg, templates, pc, device="cpu")
    files = sorted((tmp_path / "cache").iterdir())
    assert [f.suffix for f in files] == [".npy"]
    stored = np.load(files[0])
    assert stored.dtype == np.float32 and stored.shape == (len(NAMES), SMALL["embed_dim"])
    np.testing.assert_array_equal(stored, built.float().numpy())

    def no_build(*args, **kwargs):
        raise AssertionError("a cache hit must not build")

    monkeypatch.setattr(common, "build_classifier_weights", no_build)
    hit = common.build_text_weights(params, cfg, templates, pc, device="cpu")
    assert hit.dtype == torch.bfloat16 and torch.equal(hit, built)


def test_cache_key_follows_the_text_weights():
    params = tclip.params_from_numpy(_params(5))
    cfg = tclip.CLIPConfig(**SMALL)
    templates = _templates(True)
    pc = perf_preset()
    key = common._classifier_cache_key(params, cfg, templates, pc)
    assert key == common._classifier_cache_key(params, cfg, templates, pc)
    params["text"]["blocks"]["mlp"]["c_fc"]["w"][1, 3, 5] += 1e-3
    assert common._classifier_cache_key(params, cfg, templates, pc) != key
    templates[0] = ["a photo of a red panda."]
    assert common._classifier_cache_key(params, cfg, templates, pc) != key

