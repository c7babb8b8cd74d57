"""The port's checkpoint loader (``jcf_tpu_torch/models/loader.py``) vs
the JAX package's (``jcf_tpu/models/loader.py``) on synthetic state dicts
(no real checkpoint is in the repository): the same config, bitwise the
same params, both directions, the same files, the same refusal of
ResNet state dicts."""

import dataclasses
import os
import pickle

import numpy as np
import pytest

import jax
import torch

from jcf_tpu.models import clip as jclip
from jcf_tpu.models import loader as jloader
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.models import loader as tloader

torch.set_num_threads(1)

# a ViT-B/16-shaped tower at small widths (patch 16, 4 x 4 grid) and a
# patch-8 one with visual prompt tokens
CONFIGS = [
    dict(embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
         vision_patch_size=16, context_length=8, vocab_size=100, text_width=64,
         text_heads=1, text_layers=3),
    dict(embed_dim=16, image_resolution=48, vision_layers=1, vision_width=64,
         vision_patch_size=8, context_length=5, vocab_size=50, text_width=128,
         text_heads=2, text_layers=1, vision_prompt_tokens=2),
]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _jax_state_dict(kw, seed):
    cfg = jclip.CLIPConfig(**kw)
    params = jclip.init_clip_params(seed, cfg)
    if kw.get("vision_prompt_tokens"):
        params["visual"]["vpt"] = np.random.default_rng(seed).standard_normal(
            (kw["vision_prompt_tokens"], kw["vision_width"])).astype(np.float32)
    return cfg, params, jloader.state_dict_from_params(params, cfg)


@pytest.mark.parametrize("kw", CONFIGS)
def test_jax_state_dict_loads_equal(kw):
    cfg, _, sd = _jax_state_dict(kw, 0)
    ref_cfg = jloader.config_from_state_dict(sd)
    got_cfg = tloader.config_from_state_dict(sd)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    assert got_cfg.vision_seq_len == ref_cfg.vision_seq_len
    ref = jax.tree_util.tree_map(np.asarray, jloader.params_from_state_dict(sd, ref_cfg))
    _assert_trees_equal(tloader.params_from_state_dict(sd, got_cfg), ref)


@pytest.mark.parametrize("kw", CONFIGS)
def test_port_state_dict_loads_in_jax(kw):
    """The reverse direction: the port's tree -> its state dict -> JAX."""
    cfg, params, _ = _jax_state_dict(kw, 1)
    tparams = tclip.params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    sd = tloader.state_dict_from_params(tparams, tclip.CLIPConfig(**kw))
    ref_sd = jloader.state_dict_from_params(params, cfg)
    assert set(sd) == set(ref_sd)
    for k in ref_sd:
        np.testing.assert_array_equal(sd[k], np.asarray(ref_sd[k]), err_msg=k)
    back = jloader.params_from_state_dict(sd, jloader.config_from_state_dict(sd))
    _assert_trees_equal(tparams, jax.tree_util.tree_map(np.asarray, back))


@pytest.mark.parametrize("fmt", ["pickle", "torch"])
def test_load_clip_from_file(tmp_path, fmt):
    """``load_clip`` on a pickle (the reference's format) and on a torch
    archive gives the JAX loader's config and params."""
    kw = CONFIGS[0]
    _, _, sd = _jax_state_dict(kw, 2)
    sd = {k: np.asarray(v) for k, v in sd.items()}
    path = os.path.join(tmp_path, "clip.pkl" if fmt == "pickle" else "clip.pt")
    if fmt == "pickle":
        with open(path, "wb") as f:
            pickle.dump(sd, f)
    else:
        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, path)
    params, cfg = tloader.load_clip(path)
    ref_params, ref_cfg = jloader.load_clip(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.vision_patch_size == 16 and cfg.vision_seq_len == 17
    _assert_trees_equal(params, jax.tree_util.tree_map(np.asarray, ref_params))


def test_resnet_state_dict_is_refused():
    """A ModifiedResNet state dict (no ``visual.proj``) is refused by both."""
    sd = {"visual.conv1.weight": np.zeros((32, 3, 3, 3), np.float32),
          "visual.attnpool.c_proj.weight": np.zeros((64, 64), np.float32),
          "text_projection": np.zeros((64, 32), np.float32)}
    assert not tloader.is_vit_state_dict(sd) and not jloader.is_vit_state_dict(sd)
    with pytest.raises(ValueError):
        jloader.config_from_state_dict(sd)
    with pytest.raises(ValueError):
        tloader.config_from_state_dict(sd)
