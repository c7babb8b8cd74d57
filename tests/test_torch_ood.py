"""``jcf-ood`` end to end on the CPU: the port's ``run_ood_split`` and its
CLI against the JAX package's on one fixture.

The fixture: a TestSetB of seeded JPEGs of several sizes and aspects (one
grayscale, one PNG, a ``__MACOSX`` copy that the walk skips, a text file
it ignores), a 403-line synthetic ``classes.txt`` (its names rotated against the
class ids, so that predictions land on both sides of the base/new
boundary at 372), and the tiny
checkpoint of ``tests/test_pipelines_e2e.py`` (``TINY`` at vision width
128, seed 3) in the reference's pickle format. The port's runs share one
classifier cache (the CLI's ``.jcf_cache`` under the fixture's root), so
each classifier is built once.

Bars: the parity path's loader batches (center, crops, impaths) equal to
JAX's (both resample as PIL does: float32 equality); the f32 classifier
within 1e-5; the modes' logits within 1e-4; the split files byte for
byte. The throughput path draws its crop geometry from a
``torch.Generator``, so the JAX package's run has other crops: it is held
to the same file contract, to a hand composition of ``decode_batch`` and
``features_from_images`` with a generator seeded 0, and, fed
``jcf_tpu.native``'s decode, to the JAX engine's route composed on the
geometry it drew: the static calibration (amax within 1e-5, the folded
tree's scales within 1e-5, its int8 weights equal), the modes (cos >=
0.99999 in f32, 0.999 in int8), the predictions and the split files."""

import dataclasses
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.cli._args as jargs
import jcf_tpu.config as jconfig
import jcf_tpu.pipelines as jpipelines
import jcf_tpu.pipelines.common as jcommon
from jcf_tpu import native as jnative
from jcf_tpu.data import walk_test_dir as j_walk
from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
from jcf_tpu.infer import TTAEngine as JEngine
from jcf_tpu.infer.engine import _center_crop_view
from jcf_tpu.models import clip as jclip
from jcf_tpu.models import init_clip_params as j_init
from jcf_tpu.models.clip import CLIPConfig as JCLIPConfig
from jcf_tpu.models.loader import state_dict_from_params
from jcf_tpu.ops import quant as jquant
from jcf_tpu.ops.assemble_kernel import assemble_dense_rows, make_cls_row
from jcf_tpu.ops.layers import l2_normalize
from jcf_tpu.ops.view_kernel import fused_views_nchw
from jcf_tpu.tta import solve_mta_batch
from jcf_tpu_torch import config as tconfig
from jcf_tpu_torch.cli import _args as targs
from jcf_tpu_torch.cli import ood as tcli
from jcf_tpu_torch.data import DataLoader, decode_batch, walk_test_dir
from jcf_tpu_torch.infer import engine as tengine
from jcf_tpu_torch.pipelines import common as tcommon
from jcf_tpu_torch.pipelines import ood as tood
from jcf_tpu_torch.utils import Timer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_pipelines_e2e.py's TINY with a vision width of 128 (2 heads):
# the int8 engine takes an even head count
TINY = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=8, context_length=77, vocab_size=49408, text_width=128,
            text_heads=2, text_layers=2)
N_CLASSES = 403
ROTATE = 108
# (file under TestSetB, height, width, grayscale)
IMAGES = [("a/img_0.jpg", 40, 44, False), ("a/img_1.JPG", 61, 50, False),
          ("b/img_2.jpeg", 33, 70, True), ("b/img_3.jpg", 90, 120, False),
          ("b/img_4.png", 45, 38, False), ("c/img_5.jpg", 36, 36, False)]


def _files(root):
    base = os.path.join(root, "TestSetB_1.txt")
    new = os.path.join(root, "TestSetB_2.txt")
    return open(base, "rb").read(), open(new, "rb").read()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("ood")
    ds = root / "Dataset"
    rng = np.random.default_rng(0)
    for rel, h, w, gray in IMAGES:
        path = ds / "TestSetB" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 5 + yy * 2) % 256, (yy * 7) % 256, (xx * 3 + 40) % 256], -1)
        img = np.clip(img + rng.integers(-30, 30, img.shape), 0, 255).astype(np.uint8)
        pil = Image.fromarray(img).convert("L") if gray else Image.fromarray(img)
        pil.save(path)
    macosx = ds / "TestSetB" / "__MACOSX" / "a"
    macosx.mkdir(parents=True)
    shutil.copy(ds / "TestSetB" / "a" / "img_0.jpg", macosx / "img_0.jpg")
    (ds / "TestSetB" / "a" / "notes.txt").write_text("not an image\n")
    # the names rotated against the lines (the class ids): the two names this
    # random tower favours, class77 and class78, land on ids 372 (base) and
    # 373 (new)
    (ds / "classes.txt").write_text(
        "".join(f"Animal_class{(i + ROTATE) % N_CLASSES} {i}\n" for i in range(N_CLASSES)))
    params = j_init(3, JCLIPConfig(**TINY))
    ckpt = root / "tiny_clip.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump(state_dict_from_params(params, JCLIPConfig(**TINY)), f)
    common = dict(root=str(ds), classes_file=str(ds / "classes.txt"),
                  test_dir=str(ds / "TestSetB"), captions_file=str(root / "missing.txt"),
                  num_workers=2)
    jcfg = jconfig.PipelineConfig(
        data=jconfig.DataConfig(template_dir=str(root / "tmpl_jax"), **common),
        tta=jconfig.TTAConfig(n_views=5, batch_images=4),
        runtime=jconfig.RuntimeConfig(clip_checkpoint=str(ckpt), classifier_cache=None,
                                      data_parallel=False))
    tcfg = tconfig.PipelineConfig(
        data=tconfig.DataConfig(template_dir=str(root / "tmpl_torch"), **common),
        tta=tconfig.TTAConfig(n_views=5, batch_images=4),
        runtime=tconfig.RuntimeConfig(clip_checkpoint=str(ckpt),
                                      classifier_cache=str(root / ".jcf_cache")))
    jax_files = {}
    for device_crops in (False,):
        c = dataclasses.replace(jcfg, tta=dataclasses.replace(jcfg.tta, device_crops=device_crops))
        jpipelines.run_ood_split(c)
        jax_files[device_crops] = _files(str(ds))
    return {"root": root, "ds": ds, "jcfg": jcfg, "tcfg": tcfg, "jax_files": jax_files,
            "ckpt": str(ckpt)}


def test_walk_matches_jax(ws):
    test_dir = str(ws["ds"] / "TestSetB")
    got = [(d.impath, d.label, d.classname, d.domain) for d in walk_test_dir(test_dir)]
    want = [(d.impath, d.label, d.classname, d.domain) for d in j_walk(test_dir)]
    assert got == want and len(got) == len(IMAGES)
    assert not any("__MACOSX" in p for p, *_ in got)


def test_parity_loader_batches_equal_jax(ws):
    jcfg, tcfg = ws["jcfg"], ws["tcfg"]
    data = walk_test_dir(tcfg.data.test_dir)
    mcfg = tcommon.load_model_for_pipeline(tcfg)[1]
    jmcfg = jcommon.load_model_for_pipeline(jcfg)[1]
    got = list(tcommon.tta_loader(tcfg, data, mcfg, device="cpu"))
    want = list(jcommon.tta_loader(jcfg, j_walk(jcfg.data.test_dir), jmcfg))
    assert len(got) == len(want) == 2
    for (gc, gx, gl, gp, gi), (wc, wx, wl, wp, wi) in zip(got, want):
        np.testing.assert_array_equal(gc.numpy(), wc)
        np.testing.assert_array_equal(gx.numpy(), wx)
        assert gp == list(wp) and gi.tolist() == list(wi) and gl.tolist() == list(wl)


def test_parity_classifier_and_logits_match_jax(ws):
    jcfg, tcfg = ws["jcfg"], ws["tcfg"]
    params, mcfg = tcommon.load_model_for_pipeline(tcfg)
    jparams, jmcfg = jcommon.load_model_for_pipeline(jcfg)
    nocache = dataclasses.replace(tcfg, runtime=dataclasses.replace(tcfg.runtime,
                                                                    classifier_cache=None))
    w = tcommon.build_text_weights(params, mcfg, tcommon.ensure_templates(tcfg), nocache,
                                   device="cpu")
    jw = np.array(jcommon.build_text_weights(jparams, jmcfg, jcommon.ensure_templates(jcfg), jcfg))
    assert w.shape == (N_CLASSES, TINY["embed_dim"])
    np.testing.assert_allclose(w.numpy(), jw, atol=1e-5, rtol=1e-5)
    center, crops, _, _, _ = next(iter(tcommon.tta_loader(tcfg, walk_test_dir(tcfg.data.test_dir),
                                                          mcfg, device="cpu")))
    stacked = tcommon.stack_center_and_crops(center, crops)
    engine = tcommon.build_engine(params, mcfg, tcfg, device="cpu")
    logits = engine.logits(engine.features_from_crops(stacked, torch.from_numpy(jw)),
                           torch.from_numpy(jw)).numpy()
    jengine = JEngine(jparams, jmcfg, dtype=jnp.float32, n_views=tcfg.tta.n_views,
                      crop_scale=tcfg.tta.crop_scale, quant=None)
    jl = np.asarray(jengine.logits(jengine.features_from_crops(jnp.asarray(stacked.numpy()),
                                                               jnp.asarray(jw)), jnp.asarray(jw)))
    np.testing.assert_allclose(logits, jl, atol=1e-4, rtol=0)


def test_parity_split_files_byte_identical(ws):
    out = tood.run_ood_split(ws["tcfg"], device="cpu")
    files = _files(str(ws["ds"]))
    assert files == ws["jax_files"][False]
    assert out["n_base"] + out["n_new"] == len(IMAGES)
    assert out["n_base"] > 0 and out["n_new"] > 0
    assert out["base_path"] == os.path.join(str(ws["ds"]), "TestSetB_1.txt")


def _hand_composition(cfg, device="cpu"):
    """decode_batch -> features_from_images with one generator seeded 0,
    batch after batch; the engine calibrated on the first batch where the
    config asks for static scales."""
    params, mcfg = tcommon.load_model_for_pipeline(cfg)
    w = tcommon.build_text_weights(params, mcfg, tcommon.ensure_templates(cfg), cfg, device=device)
    data = walk_test_dir(cfg.data.test_dir)
    src = max(cfg.tta.resize_to * mcfg.image_resolution // 224, mcfg.image_resolution)
    gen = torch.Generator(device=device).manual_seed(0)
    engine, preds, calibrated = None, [], []
    for s in range(0, len(data), cfg.tta.batch_images):
        paths = [d.impath for d in data[s : s + cfg.tta.batch_images]]
        images = decode_batch(paths, resize_to=src, out_size=src, device=device)
        if engine is None:
            engine = tcommon.build_engine(params, mcfg, cfg, images, device=device)
            calibrated.append(images)
        modes = engine.features_from_images(images, w, generator=gen)
        preds += torch.argmax(engine.logits(modes, w), dim=-1).tolist()
    return [d.impath for d in data], preds, calibrated


@pytest.mark.parametrize("quant", [None, "int8"])
def test_throughput_path_matches_hand_composition(ws, quant, monkeypatch):
    tcfg = ws["tcfg"]
    cfg = dataclasses.replace(
        tcfg, tta=dataclasses.replace(tcfg.tta, device_crops=True, batch_images=4),
        runtime=dataclasses.replace(tcfg.runtime, quant=quant, static_quant=quant is not None,
                                    compute_dtype="float32" if quant is None else "bfloat16"))
    paths, preds, first = _hand_composition(cfg)
    built = []
    real = tcommon.build_engine

    def spy(params, mcfg, c, first_batch=None, **kw):
        built.append(first_batch)
        return real(params, mcfg, c, first_batch, **kw)

    monkeypatch.setattr(tood, "build_engine", spy)
    timer = Timer()
    out = tood.run_ood_split(cfg, device="cpu", timer=timer)
    base, new = (f.decode().splitlines() for f in _files(str(ws["ds"])))
    assert base == [p for p, y in zip(paths, preds) if y <= 372]
    assert new == [p for p, y in zip(paths, preds) if y > 372]
    assert out["n_base"] + out["n_new"] == len(IMAGES)
    assert set(timer.summary()) == {"decode_wait", "tta_batch"}
    assert timer.summary()["tta_batch"]["count"] == 2
    # one engine, calibrated on the first decoded batch under static_quant
    assert len(built) == 1
    if quant is None:
        assert built[0] is None
    else:
        torch.testing.assert_close(built[0], first[0], atol=0, rtol=0)


def _jax_modes(jp, images, geometry, text, jq):
    """``features_from_images_spec`` of the JAX engine on its fused-view
    route (``engine.py:545``), composed in interpret mode: without a tree
    the f32 route (the conv patch embedding with f32 accumulation, the
    fused tower), with the folded int8 tree the bf16 route (the int8
    patch GEMM, the assembled dense rows, the folded tower)."""
    cfg = JCLIPConfig(**TINY)
    res, p, g = cfg.image_resolution, cfg.vision_patch_size, cfg.grid_size
    dtype = jnp.float32 if jq is None else jnp.bfloat16
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtype) if a.dtype == np.float32 else jnp.asarray(a), jp)
    w4f, fb = jclip.fold_normalize_into_embed(jp["visual"]["patch_embed"]["w"], CLIP_MEAN,
                                              CLIP_STD, p)
    cy, cx, inv = (jnp.asarray(a) for a in geometry)
    b, n = cy.shape[:2]
    views = fused_views_nchw(jnp.asarray(images).astype(dtype), cy, cx, inv, res,
                             interpret=True, quantize=jq is not None)
    if jq is None:
        acc = jax.lax.conv_general_dilated(
            views.reshape(b * n, 3, res, res), jnp.transpose(w4f, (3, 0, 1, 2)), (p, p), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NHWC"), preferred_element_type=jnp.float32)
        feats = jclip.encode_image_tokens(params, cfg, acc.reshape(b * n, g * g, -1) + fb,
                                          dtype=dtype, impl="fused")
    else:
        flat = jnp.transpose(w4f, (3, 0, 1, 2)).reshape(w4f.shape[3], -1)  # engine.py:470-480
        kscale = jnp.maximum(jnp.max(jnp.abs(flat), axis=1) / 127.0, 1e-8)
        k_q = jnp.clip(jnp.round(flat / kscale[:, None]), -127, 127).astype(jnp.int8)
        k_sc, b_i8 = kscale / 254.0, fb + jnp.sum(flat, axis=1) * (127.0 / 254.0)
        x6 = (views.reshape(b * n, 3, g, p, g, p).transpose(0, 2, 4, 1, 3, 5)
              .reshape(b * n, g * g, -1))
        acc = jax.lax.dot_general(x6, k_q, (((2,), (1,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        v = params["visual"]
        lnp = v["ln_pre"]
        cls_row = make_cls_row(v["class_embedding"], v["positional_embedding"][0], lnp["scale"],
                               lnp["bias"], dtype=dtype)
        rows = assemble_dense_rows(acc.reshape(b * n, g, g, -1), k_sc, b_i8,
                                   v["positional_embedding"][1:], cls_row, lnp["scale"],
                                   lnp["bias"], dtype=dtype, interpret=True)
        feats = jclip.encode_image_rows_dense(params, cfg, rows, dtype=dtype, quant=jq,
                                              quant_folded=True)
    feats = l2_normalize(feats).reshape(b, n, -1).astype(jnp.float32)
    return np.asarray(solve_mta_batch(feats, jnp.asarray(text)))


def _jax_static_tree(jp, first_batch):
    """The JAX engine's calibration (``engine.py:358-420``, mode "full"):
    the first 32 sources center-cropped to the model resolution and
    CLIP-normalized, their per-layer LN-input amax, the folded tree with
    static ctx and hidden scales -> (amax, tree)."""
    cfg = JCLIPConfig(**TINY)
    imgs = _center_crop_view(jnp.asarray(first_batch[:32]), cfg.image_resolution)
    imgs = (imgs - jnp.asarray(CLIP_MEAN, jnp.float32).reshape(1, 3, 1, 1)) \
        / jnp.asarray(CLIP_STD, jnp.float32).reshape(1, 3, 1, 1)
    amax = np.asarray(jclip.vision_ln_z_amax(jp, cfg, imgs))
    tree = jquant.quantize_clip_params(jp, fold=True, heads={"visual": cfg.vision_heads, "text": 1},
                                       act_scales={"visual": amax},
                                       act_static=("ctx", "hidden"))["visual"]
    return amax, tree


@pytest.mark.parametrize("quant", [None, "int8"])
def test_throughput_path_matches_jax(ws, quant, monkeypatch):
    """The ``--perf`` loop on the JAX package's decode (``jcf_tpu.native``
    for both packages): the engine's static calibration on the first batch
    against the JAX engine's, and each batch's modes, predictions and the
    split files against the JAX engine's route on the geometry the port
    drew from its generator seeded 0."""
    tcfg = ws["tcfg"]
    cfg = dataclasses.replace(
        tcfg, tta=dataclasses.replace(tcfg.tta, device_crops=True, batch_images=4),
        runtime=dataclasses.replace(tcfg.runtime, quant=quant, static_quant=quant is not None,
                                    compute_dtype="float32" if quant is None else "bfloat16"))
    monkeypatch.setattr(tood, "decode_batch", lambda paths, resize_to, out_size, device: (
        torch.from_numpy(jnative.decode_batch(paths, resize_to, out_size)).to(device)))
    amaxes, batches, engines = [], [], []
    real_amax, real_build = tengine.vision_ln_z_amax, tcommon.build_engine

    def amax_spy(*args, **kw):
        amaxes.append(real_amax(*args, **kw))
        return amaxes[-1]

    def build_spy(params, mcfg, c, first_batch=None, **kw):
        engine = real_build(params, mcfg, c, first_batch, **kw)
        engines.append((engine, first_batch))
        draw, serve = engine.sample_geometry, engine.features_from_images

        def sample_geometry(*a):
            batches[-1]["geometry"] = draw(*a)
            return batches[-1]["geometry"]

        def features_from_images(images, text_weights, **k):
            batches.append({"images": images, "text": text_weights})
            batches[-1]["modes"] = serve(images, text_weights, **k)
            return batches[-1]["modes"]

        engine.sample_geometry, engine.features_from_images = sample_geometry, features_from_images
        return engine

    monkeypatch.setattr(tengine, "vision_ln_z_amax", amax_spy)
    monkeypatch.setattr(tood, "build_engine", build_spy)
    tood.run_ood_split(cfg, device="cpu")

    jp = jax.tree_util.tree_map(np.asarray, j_init(3, JCLIPConfig(**TINY)))
    (engine, first), = engines
    jq = None
    if quant is None:
        assert first is None and not amaxes
    else:
        np.testing.assert_array_equal(first.numpy(), batches[0]["images"].numpy())
        amax, jq = _jax_static_tree(jp, first.numpy())
        (got_amax,) = amaxes
        np.testing.assert_allclose(got_amax.numpy(), amax, rtol=1e-5, atol=1e-5)
        for half in ("attn", "mlp"):
            assert set(engine._quant[half]) == set(jq[half]), half
            for name, r in jq[half].items():
                g = engine._quant[half][name]
                if isinstance(r, jquant.QuantizedLinear):
                    np.testing.assert_array_equal(g.w_int8.numpy(), np.asarray(r.w_int8))
                    np.testing.assert_allclose(g.w_scale.numpy(), np.asarray(r.w_scale), rtol=1e-5)
                else:
                    np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, err_msg=name)
        assert {"ctx_inv", "ln_inv"} <= set(jq["attn"]) and {"h_inv", "ln_inv"} <= set(jq["mlp"])
    assert len(batches) == 2
    preds = []
    for bt in batches:
        text = bt["text"].float().numpy()
        ref = _jax_modes(jp, bt["images"].float().numpy(),
                         [a.numpy() for a in bt["geometry"]], text, jq)
        got = bt["modes"].numpy()
        cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
        assert cos.min() >= (0.99999 if quant is None else 0.999), cos
        if quant is None:
            np.testing.assert_allclose(got @ text.T * 100.0, ref @ text.T * 100.0, atol=1e-4,
                                       rtol=0)
        np.testing.assert_array_equal((got @ text.T).argmax(-1), (ref @ text.T).argmax(-1))
        preds += (ref @ text.T).argmax(-1).tolist()
    paths = [d.impath for d in walk_test_dir(cfg.data.test_dir)]
    base, new = (f.decode().splitlines() for f in _files(str(ws["ds"])))
    assert base == [p for p, y in zip(paths, preds) if y <= 372]
    assert new == [p for p, y in zip(paths, preds) if y > 372]
    assert base and new


class _Items:
    """A dataset of ``n`` ints that raises on ``bad``."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise IOError(f"item {i} is unreadable")
        return i, f"p{i}", np.full((2,), i, np.uint8)


def test_loader_keeps_order_and_raises_worker_errors():
    """Batches of ``batch_size`` in dataset order, the last one short; a
    sample's exception reaches the consumer, after the batches before it."""
    loader = DataLoader(_Items(11), batch_size=4, num_workers=3)
    got = list(loader)
    assert len(loader) == len(got) == 3
    assert [b[0].tolist() for b in got] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]
    assert got[2][1] == ["p8", "p9", "p10"] and got[0][0].dtype == torch.int32
    assert got[1][2].shape == (4, 2) and got[1][2][:, 0].tolist() == [4, 5, 6, 7]
    seen = []
    with pytest.raises(IOError, match="item 9"):
        for b in DataLoader(_Items(11, bad=9), batch_size=4, num_workers=3):
            seen.append(b[0].tolist())
    assert seen == [[0, 1, 2, 3], [4, 5, 6, 7]]


def _argv(ws, *extra):
    return ["--root_path", str(ws["ds"]), "--clip_checkpoint", ws["ckpt"], "--n_views", "5",
            "--batch_images", "4", *extra]


@pytest.mark.parametrize("perf", [False, True])
def test_cli_writes_the_pipelines_files(ws, perf, monkeypatch):
    """``cli.ood.main`` on the fixture (the templates and cache under the
    working directory, as the CLI leaves them) gives the files of
    ``run_ood_split`` on the config it builds."""
    monkeypatch.chdir(ws["root"])
    extra = ["--perf"] if perf else []
    timer = Timer()
    out = tcli.main(_argv(ws, *extra, "--device", "cpu"), timer=timer)
    assert timer.summary()["tta_batch"]["count"] == 2
    files = _files(str(ws["ds"]))
    cfg = targs.config_from_args(targs.build_parser("x", 1).parse_args(_argv(ws, *extra)))
    assert cfg.tta.device_crops == perf and cfg.runtime.classifier_cache == ".jcf_cache"
    assert tood.run_ood_split(cfg, device="cpu") == out
    assert _files(str(ws["ds"])) == files
    if not perf:
        assert files == ws["jax_files"][False]


def test_cli_process_writes_jax_files(ws, tmp_path):
    """``python -m jcf_tpu_torch.cli.ood ... --device cpu`` as a process,
    from its own working directory: the parity path's split files equal
    the JAX package's byte for byte."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "jcf_tpu_torch.cli.ood", *_argv(ws, "--device", "cpu")],
                   cwd=tmp_path, env=env, check=True, timeout=600, capture_output=True)
    assert _files(str(ws["ds"])) == ws["jax_files"][False]
    assert (tmp_path / "text_template").is_dir() and (tmp_path / ".jcf_cache").is_dir()


def test_cli_refuses_attention_impl(ws, monkeypatch):
    monkeypatch.chdir(ws["root"])
    with pytest.raises(ValueError, match="attention_impl"):
        tcli.main(_argv(ws, "--attention_impl", "pallas", "--device", "cpu"))


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


@pytest.mark.parametrize("argv", [
    [],
    ["--perf"],
    ["--root_path", "/data/x", "--n_views", "16", "--batch_images", "3", "--dtype", "bfloat16"],
    ["--perf", "--n_views", "32", "--dtype", "float32", "--attention_impl", "xla", "--seed", "7"],
    ["--shots", "2", "--r", "8", "--alpha", "2", "--params", "q", "v", "--encoder", "text",
     "--position", "top3", "--lr", "1e-3", "--batch_size", "64", "--clip_checkpoint", "b.pkl"],
])
def test_config_from_args_matches_jax(argv):
    """Every field the port's config has equals the JAX config's, built
    from the same command line."""
    got = _fields(targs.config_from_args(targs.build_parser("x", 1).parse_args(argv)))
    want = _fields(jargs.config_from_args(jargs.build_parser("x", 1).parse_args(argv)))
    for section, fields in got.items():
        for name, value in fields.items():
            assert value == want[section][name], (section, name, value, want[section][name])
    assert targs.build_parser("x", 1).parse_args(argv).seed == \
        jargs.build_parser("x", 1).parse_args(argv).seed
