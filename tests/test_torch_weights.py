"""Port weights vs the JAX package: the seeded init, leaf for leaf; the
numpy bridge; the config and the CLIP pixel constants."""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
from jcf_tpu.models import clip as jclip
from jcf_tpu_torch.models import clip as tclip

torch.set_num_threads(1)

SMALL = dict(
    embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=8, vocab_size=100, text_width=64,
    text_heads=1, text_layers=1,
)
PROMPTED = dict(SMALL, vision_prompt_tokens=2, vision_prompt_depth=2,
                text_prompt_depth=2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("cfg_kw", [SMALL, PROMPTED], ids=["vanilla", "prompted"])
@pytest.mark.parametrize("seed", [0, 7])
def test_init_matches_jax_leaf_for_leaf(cfg_kw, seed):
    ref = _flat(jclip.init_clip_params(seed, jclip.CLIPConfig(**cfg_kw)))
    got = _flat(tclip.init_clip_params(seed, tclip.CLIPConfig(**cfg_kw)))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_config_matches_jax():
    assert dataclasses.asdict(tclip.VIT_B_32) == dataclasses.asdict(jclip.VIT_B_32)
    for kw in (SMALL, PROMPTED):
        t, j = tclip.CLIPConfig(**kw), jclip.CLIPConfig(**kw)
        assert (t.vision_heads, t.grid_size, t.vision_seq_len) == (
            j.vision_heads, j.grid_size, j.vision_seq_len)
    assert tclip.VIT_B_32.vision_seq_len == 50


def test_params_from_numpy_round_trip():
    jparams = jclip.init_clip_params(5, jclip.CLIPConfig(**SMALL))
    ref = _flat(jparams)
    tree = tclip.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    assert all(isinstance(v, torch.Tensor) for v in jax.tree_util.tree_leaves(tree))
    got = _flat(tree)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # tensors -> numpy -> tensors again; the bridge copies, so changing the
    # numpy tree afterwards leaves the tensors as they were
    back = jax.tree_util.tree_map(lambda t: t.numpy(), tree)
    again = tclip.params_from_numpy(back)
    back["visual"]["proj"][...] = 0.0
    got = _flat(again)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_clip_constants_match_jax():
    assert tclip.CLIP_MEAN == CLIP_MEAN
    assert tclip.CLIP_STD == CLIP_STD
