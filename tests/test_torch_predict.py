"""``jcf-predict`` on the CPU: the port's pieces and its ``run_predict`` and
CLI against the JAX package's on one seeded workspace.

The workspace (the names ``jcf-predict``'s defaults read, under a
temporary directory): the tiny checkpoint of ``tests/test_torch_ood.py``
(vision width 128, 2 heads, seed 3); a stage-1 LoRA (r 2 on q, k, v of
both towers, non-zero B factors, so that merging changes the weights);
stage 2's artifacts written directly with the JAX writers: the checkpoint
with 4 visual prompt tokens (21 rows a crop), its own LoRA, the channel LP
and MoCo adapter heads, the prompt learner's ctx; a seed-0 ResNet-50 with
BatchNorm statistics of a trained tower, as a ``base_encoder.``-prefixed
MoCo state dict; a 403-line ``classes.txt`` with the names rotated
against the ids; the committed fixture JPEGs split 4 / 2 into
``TestSetB_1.txt`` and ``TestSetB_2.txt``.

Bars: the writers, the merge and the cleanup byte for byte; the ensemble
formulas, the heads and ``logit_normalize`` within 1e-6; the prompt
learner's ids and embeddings equal and its text features within 1e-5 (f32);
the ResNet-50 within 1e-4 (f32; rtol and atol); the loader's raw-pixel,
area-0.2-1 batches float-equal to JAX's (both resample as PIL does);
``run_predict`` and the CLI (f32 default configuration): ``cs1`` within
1e-4 of JAX's and the three result files byte for byte, also from an SWA
folder."""

import dataclasses
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.cli._args as jargs
import jcf_tpu.config as jconfig
import jcf_tpu.pipelines.common as jcommon
import jcf_tpu.pipelines.predict as jpredict
from jcf_tpu.data import read_path_list as j_read_path_list
from jcf_tpu.heads import channel_lp as j_channel_lp
from jcf_tpu.heads import init_channel_lp as j_init_channel_lp
from jcf_tpu.heads import init_moco_adapter as j_init_moco_adapter
from jcf_tpu.heads import moco_adapter as j_moco_adapter
from jcf_tpu.heads import moco_adapter_init_from_features as j_moco_init
from jcf_tpu.infer import predict as jip
from jcf_tpu.models import clip as jclip
from jcf_tpu.models import resnet as jresnet
from jcf_tpu.models.loader import state_dict_from_params
from jcf_tpu.ops import stats as jstats
from jcf_tpu.peft import init_lora_params as j_init_lora
from jcf_tpu.peft import init_prompt_learner as j_init_prompt
from jcf_tpu.peft import prompt_text_features as j_prompt_text_features
from jcf_tpu.peft import save_lora as j_save_lora
from jcf_tpu.pipelines.train_lora import lora_spec_from_config as j_spec
from jcf_tpu.utils import save_pytree as j_save_pytree
from jcf_tpu_torch import config as tconfig
from jcf_tpu_torch import heads as theads
from jcf_tpu_torch.cli import _args as targs
from jcf_tpu_torch.cli import predict as tcli
from jcf_tpu_torch import data as tdata_mod
from jcf_tpu_torch.data import read_path_list as t_read_path_list
from jcf_tpu_torch.infer import predict as tip
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.models import resnet as tresnet
from jcf_tpu_torch.models.loader import load_state_dict_file
from jcf_tpu_torch.ops import stats as tstats
from jcf_tpu_torch.ops.layers import require_f32_products
from jcf_tpu_torch.peft import init_prompt_learner, prompt_text_features
from jcf_tpu_torch.pipelines import common as tcommon
from jcf_tpu_torch.pipelines import predict as tpredict
from jcf_tpu_torch.utils import Timer, load_pytree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = os.path.join(ROOT, "tests", "fixtures", "jpeg")
TINY = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=8, context_length=77, vocab_size=49408, text_width=128,
            text_heads=2, text_layers=2)
N_CLASSES, ROTATE = 403, 108
# the flags of both CLIs (the JAX one parsed with its own parser)
ARGV = ["--root_path", "Dataset", "--clip_checkpoint", "tiny_clip.pkl", "--r", "2",
        "--n_views", "5", "--batch_images", "2"]


def _rn50_params(seed=0):
    """JAX's seed-0 RN50 with BatchNorm statistics of a trained tower
    (scales 0.2-0.6, running variances 0.5-2; identity BatchNorms let the
    random tower's features grow to ~1e3), numpy leaves."""
    params = jax.tree_util.tree_map(np.asarray, jresnet.init_resnet50_params(seed))
    rng = np.random.default_rng(seed + 5)

    def stats(bn):
        c = bn["weight"].shape[0]
        bn["weight"] = rng.uniform(0.2, 0.6, c).astype(np.float32)
        bn["running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        bn["bias"] = (0.05 * rng.standard_normal(c)).astype(np.float32)
        bn["running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)

    stats(params["bn1"])
    for stage in params["layers"]:
        for block in stage:
            for i in (1, 2, 3):
                stats(block[f"bn{i}"])
            if "downsample" in block:
                stats(block["downsample"]["bn"])
    return params


def moco_state_dict(params, prefix="base_encoder."):
    """A MoCo-v3 checkpoint of an RN50 tree (torchvision names), with the
    projection head a real checkpoint carries beside the backbone."""
    sd = {f"{prefix}conv1.weight": np.asarray(params["conv1"])}
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{prefix}bn1.{k}"] = np.asarray(params["bn1"][k])
    for si, stage in enumerate(params["layers"], start=1):
        for b, blk in enumerate(stage):
            pre = f"{prefix}layer{si}.{b}"
            for ci in (1, 2, 3):
                sd[f"{pre}.conv{ci}.weight"] = np.asarray(blk[f"conv{ci}"])
                for k in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{pre}.bn{ci}.{k}"] = np.asarray(blk[f"bn{ci}"][k])
            if "downsample" in blk:
                sd[f"{pre}.downsample.0.weight"] = np.asarray(blk["downsample"]["conv"])
                for k in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{pre}.downsample.1.{k}"] = np.asarray(blk["downsample"]["bn"][k])
    sd[f"{prefix}fc.0.weight"] = np.zeros((16, 2048), np.float32)
    return sd


def _lora(seed, spec):
    """JAX LoRA factors with non-zero B."""
    lora = j_init_lora(seed, spec, n_text=2, text_width=128, n_vision=2, vision_width=128)
    rng = np.random.default_rng(seed + 100)
    return {t: {k: (jnp.asarray((0.05 * rng.standard_normal(v.shape)).astype(np.float32))
                    if k.startswith("b_") else v) for k, v in tower.items()}
            for t, tower in lora.items()}


def _write_workspace(root):
    rng = np.random.default_rng(0)
    ds = root / "Dataset"
    ds.mkdir()
    (ds / "classes.txt").write_text(
        "".join(f"Animal_class{(i + ROTATE) % N_CLASSES} {i}\n" for i in range(N_CLASSES)))
    jpegs = sorted(os.path.join(JPEGS, f) for f in os.listdir(JPEGS) if f.endswith(".jpg"))
    (ds / "TestSetB_1.txt").write_text("".join(p + "\n" for p in jpegs[:4]))
    (ds / "TestSetB_2.txt").write_text("".join(p + "\n" for p in jpegs[4:]))
    cfg = jclip.CLIPConfig(**TINY)
    params = jclip.init_clip_params(3, cfg)
    with open(root / "tiny_clip.pkl", "wb") as f:
        pickle.dump(state_dict_from_params(params, cfg), f)
    spec = j_spec(jargs.config_from_args(jargs.build_parser("t", 1).parse_args(ARGV)))
    j_save_lora(_lora(1, spec), spec, str(root / "lora_weights1" / "lora_weights.pkl"),
                n_text=2, n_vision=2)
    # stage 2's artifacts, as jcf_tpu/pipelines/train_joint.py writes them
    out = root / "test_pkl"
    vis = dict(params["visual"])
    vis["vpt"] = jnp.asarray((0.02 * rng.standard_normal((4, 128))).astype(np.float32))
    j_save_pytree(state_dict_from_params(dict(params, visual=vis), cfg),
                  str(out / "clip_model.pkl"))
    j_save_lora(_lora(2, spec), spec, str(out / "lora_weights.pkl"), n_text=2, n_vision=2)
    text = rng.standard_normal((N_CLASSES, 32)).astype(np.float32)
    lp = j_init_channel_lp(N_CLASSES, 32, text_weights=jnp.asarray(text))
    lp["scale1"] = jnp.asarray((1 + 0.1 * rng.standard_normal(32)).astype(np.float32))
    lp["bias1"] = jnp.asarray((0.01 * rng.standard_normal(32)).astype(np.float32))
    j_save_pytree(lp, str(out / "channel.pkl"))
    sums = np.abs(rng.standard_normal((N_CLASSES, 2048))).astype(np.float32)
    j_save_pytree(j_init_moco_adapter(N_CLASSES, 2048, jnp.asarray(sums)),
                  str(out / "moco_adapter.pkl"))
    ctx = np.asarray(params["text"]["token_embedding"])[[320, 1125, 539, 320]]
    j_save_pytree({"ctx": ctx + (0.01 * rng.standard_normal(ctx.shape)).astype(np.float32)},
                  str(out / "PromptLearner.pkl"))
    with open(root / "r-50-1000ep.pkl", "wb") as f:
        pickle.dump(moco_state_dict(_rn50_params(0)), f)


def _jax_cfg(argv, **stage1):
    c = jargs.config_from_args(jargs.build_parser("t", 346373).parse_args(argv))
    return dataclasses.replace(
        c, data=dataclasses.replace(c.data, template_dir="tmpl_jax", captions_file="missing.txt"),
        runtime=dataclasses.replace(c.runtime, classifier_cache=None, data_parallel=False),
        stage1=dataclasses.replace(c.stage1, **stage1))


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in ("top5_results6.txt", "top5_results_ood.txt", "result.txt")}


def _capture(monkeypatch, module):
    """Records the ensembles of every base batch of ``module``'s
    run_predict; ``_cat`` joins them."""
    seen = []
    real = module.ensemble_base_logits

    def wrapped(*args):
        out = real(*args)
        seen.append({k: np.asarray(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(module, "ensemble_base_logits", wrapped)
    return seen


def _cat(seen, key):
    return np.concatenate([s[key] for s in seen])


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _write_workspace(root)
        mp = pytest.MonkeyPatch()
        cs1 = _capture(mp, jpredict)
        jpredict.run_predict(_jax_cfg(ARGV), results_dir="final_jax")
        mp.undo()
        yield {"root": root, "jax_files": _files("final_jax"), "jax_cs1": _cat(cs1, "cs1"),
               "jax_cs3": _cat(cs1, "cs3")}
    finally:
        os.chdir(cwd)


@pytest.fixture
def in_ws(ws):
    cwd = os.getcwd()
    os.chdir(ws["root"])
    try:
        yield ws
    finally:
        os.chdir(cwd)


def _torch_cfg(argv, **stage1):
    c = targs.config_from_args(targs.build_parser("t", 346373).parse_args(argv))
    return dataclasses.replace(
        c, data=dataclasses.replace(c.data, captions_file="missing.txt"),
        stage1=dataclasses.replace(c.stage1, **stage1))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def test_ensemble_and_heads_match_jax():
    rng = np.random.default_rng(1)
    modes = [rng.standard_normal((3, 32)).astype(np.float32) for _ in range(3)]
    texts = [rng.standard_normal((N_CLASSES, 32)).astype(np.float32) for _ in range(3)]
    lp_logits, moco = (rng.standard_normal((3, N_CLASSES)).astype(np.float32) for _ in range(2))
    ref = jip.ensemble_base_logits(*map(jnp.asarray, modes + texts + [lp_logits, moco]))
    got = tip.ensemble_base_logits(*map(torch.from_numpy, modes + texts + [lp_logits, moco]))
    assert sorted(got) == sorted(ref) == ["cs", "cs1", "cs2", "cs3", "cs4", "cs5", "cs6", "cs7"]
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)
    a, b = lp_logits, moco
    np.testing.assert_allclose(tip.combine_lp_logits(torch.from_numpy(a), torch.from_numpy(b)),
                               np.asarray(jip.combine_lp_logits(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tstats.logit_normalize(torch.from_numpy(a)),
                               np.asarray(jstats.logit_normalize(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-6)
    targets = rng.integers(0, N_CLASSES, 3)
    for fn in ("top_k_accuracy", "boundary_accuracy"):
        for k in (1, 5):
            got = getattr(tstats, fn)(torch.from_numpy(b), torch.from_numpy(targets), k)
            ref = getattr(jstats, fn)(jnp.asarray(b), jnp.asarray(targets), k)
            assert float(got) == pytest.approx(float(ref))
    assert [tip.ood_side(p) for p in (0, 372, 373, 402)] == ["base", "base", "new", "new"]
    # the heads on their own pickles' trees
    lp = j_init_channel_lp(N_CLASSES, 32, text_weights=jnp.asarray(texts[0]))
    lp["scale1"] = jnp.asarray(rng.uniform(0.5, 1.5, 32).astype(np.float32))
    feats = rng.standard_normal((3, 32)).astype(np.float32)
    tlp = jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), lp)
    np.testing.assert_allclose(theads.channel_lp(tlp, torch.from_numpy(feats)).numpy(),
                               np.asarray(j_channel_lp(lp, jnp.asarray(feats))), rtol=1e-6,
                               atol=1e-6)
    mf = rng.standard_normal((5, 2048)).astype(np.float32)
    labels = np.array([0, 2, 2, 402, 0])
    sums = j_moco_init(jnp.asarray(mf), jnp.asarray(labels), N_CLASSES)
    tsums = theads.moco_adapter_init_from_features(torch.from_numpy(mf), torch.from_numpy(labels),
                                                   N_CLASSES)
    np.testing.assert_allclose(tsums.numpy(), np.asarray(sums), rtol=1e-6, atol=1e-6)
    ad = j_init_moco_adapter(N_CLASSES, 2048, sums)
    tad = theads.init_moco_adapter(N_CLASSES, 2048, tsums)
    np.testing.assert_allclose(theads.moco_adapter(tad, torch.from_numpy(mf)).numpy(),
                               np.asarray(j_moco_adapter(ad, jnp.asarray(mf))), rtol=1e-5,
                               atol=1e-4)
    assert theads.init_channel_lp(N_CLASSES, 32)["fc"]["w"].abs().sum() == 0


def test_writers_and_cleanup_byte_equal_jax(tmp_path):
    rows = [("Dataset/TestSetB/a/img_0.jpg", [3, 1, 4, 1, 5]),
            ("Dataset/TestSetB/b/img 1.jpg", np.array([9, 2, 6, 5, 3])),
            ("x.png", [400, 0, 372, 373, 2])]
    new = [("Dataset/TestSetB/b/img 1.jpg", [402, 401, 400, 399, 398]), ("y.jpg", [5, 4, 3, 2, 1])]
    out = {}
    for tag, mod in (("t", tip), ("j", jip)):
        d = tmp_path / tag
        mod.write_top5(str(d / "base.txt"), rows)
        mod.write_top5(str(d / "ood.txt"), new)
        mod.write_top5(str(d / "plain.txt"), rows, reference_format=False)
        mod.update_txt_file(str(d / "base.txt"), str(d / "ood.txt"))
        mod.process_result_lines(str(d / "base.txt"), str(d / "res" / "result.txt"))
        out[tag] = [open(d / n, "rb").read() for n in ("base.txt", "ood.txt", "plain.txt",
                                                       os.path.join("res", "result.txt"))]
        # a space in the path splits the key, as in the reference
        assert mod.load_txt_to_dict(str(d / "ood.txt")) == {
            "['y.jpg']": ["5", "4", "3", "2", "1"],
            "['Dataset/TestSetB/b/img": ["1.jpg']", "402", "401", "400", "399", "398"]}
    assert out["t"] == out["j"]
    assert out["t"][0].startswith(b"['Dataset/TestSetB/a/img_0.jpg'] 3 1 4 1 5\n")
    assert out["t"][3].startswith(b"img_0.jpg 3 1 4 1 5\n")
    for line in ("['a/b/c.jpg'] 1 2", "no list here 1", "['x.jpg'] ['y.jpg'] 3"):
        assert tip.process_line(line) == jip.process_line(line)


def test_prompt_learner_matches_jax():
    cfg = dict(TINY, text_layers=1)
    jp = jclip.init_clip_params(2, jclip.CLIPConfig(**cfg))
    tp = tclip.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    names = ["Animal_giant_panda", "Thu-dog", "Caltech-101_" + "very_long_name_" * 12, "x"]
    ref = j_init_prompt(jp, jclip.CLIPConfig(**cfg), names, "a photo of a", 4)
    got = init_prompt_learner(tp, tclip.CLIPConfig(**cfg), names, "a photo of a", 4)
    for field in ("ctx", "token_prefix", "token_suffix", "tokenized"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert got.tokenized.dtype == torch.int32 and got.token_suffix.shape == (4, 72, 128)
    ctx = np.random.default_rng(2).standard_normal((4, 128)).astype(np.float32) * 0.02
    feats_ref = np.asarray(j_prompt_text_features(jp, jclip.CLIPConfig(**cfg), ref,
                                                  jnp.asarray(ctx)))
    feats = prompt_text_features(tp, tclip.CLIPConfig(**cfg), got, torch.from_numpy(ctx))
    assert feats.shape == (4, 32) and feats.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), feats_ref, rtol=1e-5, atol=1e-5)


def test_resnet50_matches_jax():
    """2 images of 64²: f32 features within 1e-4, through a MoCo state
    dict both loaders read (the prefix stripped, ``fc`` dropped, a flat
    dict too)."""
    params = _rn50_params(0)
    imgs = np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(np.float32)
    ref = np.asarray(jresnet.resnet50_features(params, jnp.asarray(imgs)))
    sd = moco_state_dict(params)
    tparams = tresnet.moco_params_from_state_dict(sd)
    jtree = jresnet.moco_params_from_state_dict(sd)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree),
                            jax.tree_util.tree_leaves(tparams)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(path))
    got = tresnet.resnet50_features(tparams, torch.from_numpy(imgs))
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    flat = tresnet.moco_params_from_state_dict(moco_state_dict(params, prefix=""))
    assert torch.equal(tresnet.resnet50_features(flat, torch.from_numpy(imgs)), got)
    init = tresnet.init_resnet50_params(0)
    for a, b in zip(jax.tree_util.tree_leaves(jresnet.init_resnet50_params(0)),
                    jax.tree_util.tree_leaves(init)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_f32_guard_reads_both_tf32_flags(monkeypatch):
    """The guard reads only the flags, so a CPU test holds it with a CUDA
    device: either flag on refuses, both off pass, the CPU never refuses."""
    cuda = torch.device("cuda")
    for matmul, cudnn in ((True, False), (False, True)):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
        flag = "cudnn.allow_tf32" if cudnn else "matmul.allow_tf32"
        with pytest.raises(RuntimeError, match=flag):
            require_f32_products(cuda, "the f32 ResNet-50")
        require_f32_products(torch.device("cpu"), "the f32 ResNet-50")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    require_f32_products(cuda, "the f32 ResNet-50")


def test_predict_loader_batches_equal_jax(in_ws):
    """``tta_loader(normalize=False, crop_scale=(0.2, 1.0))``: raw [0, 1]
    pixels in the center view and the crops, the crops' area share 0.2-1;
    float-equal to JAX's loader. The default loader still normalizes."""
    jcfg, tcfg = _jax_cfg(ARGV), _torch_cfg(ARGV)
    data = j_read_path_list("Dataset/TestSetB_1.txt")
    tdata = t_read_path_list("Dataset/TestSetB_1.txt")
    assert [d.impath for d in tdata] == [d.impath for d in data]
    mcfg = tclip.CLIPConfig(**TINY)
    for kw in (dict(normalize=False, crop_scale=(0.2, 1.0)), {}):
        got = list(tcommon.tta_loader(tcfg, tdata, mcfg, device="cpu", **kw))
        want = list(jcommon.tta_loader(jcfg, data, jclip.CLIPConfig(**TINY), **kw))
        assert len(got) == len(want) == 2
        for (gc, gx, _, gp, _), (wc, wx, _, wp, _) in zip(got, want):
            np.testing.assert_array_equal(gc.numpy(), wc)
            np.testing.assert_array_equal(gx.numpy(), wx)
            assert gp == list(wp)
        in_unit = bool(got[0][0].min() >= 0 and got[0][1].min() >= 0 and got[0][1].max() <= 1)
        assert in_unit == bool(kw)
    # the dataset's own knob: the raw center view is the normalized one's pixels
    sampler = tdata_mod.TTACropSampler(n_views=2, size=32, seed=0)
    raw = tdata_mod.TTADataset(tdata, sampler, size=32, center_normalize=False, device="cpu")[0][0]
    norm = tdata_mod.TTADataset(tdata, sampler, size=32, device="cpu")[0][0]
    np.testing.assert_allclose(tdata_mod.normalize(raw).numpy(), norm.numpy(), rtol=0, atol=0)
    # the MoCo input statistics the pipeline normalizes the center view with
    from jcf_tpu.data.transforms import MOCO_MEAN, MOCO_STD
    assert (tdata_mod.MOCO_MEAN, tdata_mod.MOCO_STD) == (MOCO_MEAN, MOCO_STD)


def test_predict_artifacts_load_as_jax_trees(in_ws):
    """Each stage-2 artifact the JAX writers made loads in the port as the
    JAX loader reads it, array for array."""
    from jcf_tpu.models.loader import load_state_dict_file as j_load_sd
    from jcf_tpu.utils import load_pytree as j_load_pytree

    for name in ("channel.pkl", "moco_adapter.pkl", "PromptLearner.pkl"):
        ref = j_load_pytree(os.path.join("test_pkl", name))
        got = load_pytree(os.path.join("test_pkl", name))
        assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, got))
        for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    sd, jsd = load_state_dict_file("test_pkl/clip_model.pkl"), j_load_sd("test_pkl/clip_model.pkl")
    assert sorted(sd) == sorted(jsd) and sd["visual.VPT"].shape == (4, 128)
    for k in jsd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)


def test_config_from_args_matches_jax():
    """Field by field, every section the port keeps, for the predict CLI's
    flags and the perf preset; ``Stage2Config`` whole."""
    assert ([f.name for f in dataclasses.fields(tconfig.Stage2Config)]
            == [f.name for f in dataclasses.fields(jconfig.Stage2Config)])
    for argv in (ARGV, ARGV + ["--perf", "--lr", "1e-3", "--batch_size", "7"]):
        t = targs.config_from_args(targs.build_parser("t", 346373).parse_args(argv))
        j = jargs.config_from_args(jargs.build_parser("t", 346373).parse_args(argv))
        for section in ("data", "runtime", "lora", "stage1", "tta", "stage2"):
            ts, js = getattr(t, section), getattr(j, section)
            for f in dataclasses.fields(ts):
                assert getattr(ts, f.name) == getattr(js, f.name), (section, f.name)
    assert tconfig.PipelineConfig().stage2 == tconfig.Stage2Config()


# ---------------------------------------------------------------------------
# the pipeline and the CLI
# ---------------------------------------------------------------------------


def test_run_predict_matches_jax(in_ws, monkeypatch):
    cs1 = _capture(monkeypatch, tpredict)
    timer = Timer()
    out = tpredict.run_predict(_torch_cfg(ARGV), results_dir="final_torch", device="cpu",
                               timer=timer)
    assert out == {"n_base": 4, "n_new": 2, "result": os.path.join("final_torch", "result.txt")}
    got = _cat(cs1, "cs1")
    assert got.shape == in_ws["jax_cs1"].shape == (4, N_CLASSES)
    np.testing.assert_allclose(got, in_ws["jax_cs1"], atol=1e-4, rtol=0)
    assert _files("final_torch") == in_ws["jax_files"]
    lines = in_ws["jax_files"]["result.txt"].decode().splitlines()
    assert len(lines) == 6 and all(len(line.split()) == 6 and "/" not in line for line in lines)
    summary = timer.summary()
    assert summary["base_batch"]["count"] == 2 and summary["new_batch"]["count"] == 1
    assert {"load", "classifiers", "engines", "decode_wait", "write"} <= set(summary)


def test_cli_matches_jax(in_ws):
    out = tcli.main(ARGV + ["--device", "cpu", "--results_dir", "final_cli"])
    assert out["n_base"] == 4 and out["n_new"] == 2
    assert _files("final_cli") == in_ws["jax_files"]


def test_swa_dir_matches_jax(in_ws, monkeypatch):
    """``--swa_dir``: the stage-1 LoRA averaged over a folder (w and 3w ->
    2w, which differs from the single checkpoint) in both packages."""
    with open("lora_weights1/lora_weights.pkl", "rb") as f:
        payload = pickle.load(f)
    os.makedirs("swa", exist_ok=True)
    with open("swa/epoch1.pkl", "wb") as f:
        pickle.dump(payload, f)
    scaled = {"metadata": payload["metadata"],
              "weights": {layer: {proj: {k: 3.0 * v for k, v in d.items()}
                                  for proj, d in projs.items()}
                          for layer, projs in payload["weights"].items()}}
    with open("swa/epoch2.pkl", "wb") as f:
        pickle.dump(scaled, f)
    jcs1 = _capture(monkeypatch, jpredict)
    jpredict.run_predict(_jax_cfg(ARGV, swa_dir="swa"), results_dir="final_swa_jax")
    tcs1 = _capture(monkeypatch, tpredict)
    tcli.main(ARGV + ["--device", "cpu", "--results_dir", "final_swa", "--swa_dir", "swa"])
    # the averaged stage-1 LoRA moves the zs tower's ensemble (cs3), not cs1
    for key in ("cs1", "cs3"):
        np.testing.assert_allclose(_cat(tcs1, key), _cat(jcs1, key), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(_cat(jcs1, "cs1"), in_ws["jax_cs1"])
    assert np.abs(_cat(jcs1, "cs3") - in_ws["jax_cs3"]).max() > 1e-3
    assert _files("final_swa") == _files("final_swa_jax")
