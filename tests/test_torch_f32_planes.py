"""The f32 towers' weights split into their TF32 planes once a tree
(``ops.f32_gemm.with_tf32_planes``), never once a GEMM call.

- The planes [L, 2, N, K] equal ``tf32_split_plain`` of each layer of each
  stacked f32 GEMM weight bit for bit; `with_tf32_planes` copies the dicts on the
  weights' paths and keeps planes a tree already has.
- Every f32 tree made for serving carries them: ``TTAEngine``'s
  unquantized f32 tower, the classifier builds (``build_text_weights`` and
  both paths of ``build_classifier_weights``), the prompt learner's text
  tower, and ``run_predict``'s towers, whose planes are the split of the
  LoRA-merged weights. The bf16 trees carry none.
- ``run_float_tower`` on a tree with planes still matches the JAX
  package's ``_attn_half_kernel`` / ``_mlp_half_kernel`` in interpret mode
  at ``tests/test_torch_float_tower.py``'s bars (5e-4 a block, 1e-3 at
  the end).
- ``make_stage1_step`` in f32 splits each tower that LoRA leaves out
  (it runs the fused route) and no other.
- A CUDA f32 product without planes raises before any launch; the check
  runs on CPU tensors through the wrappers' launch paths, which test the
  planes before they load the kernel library.
"""

import dataclasses
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

import test_torch_float_tower as ft
import test_torch_predict as tp
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops.attention import causal_mask
from jcf_tpu_torch import config as tconfig
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops import f32_gemm as tfg
from jcf_tpu_torch.ops.layers import layer_slice
from jcf_tpu_torch.pipelines import common as tcommon
from jcf_tpu_torch.pipelines import predict as tpredict
from jcf_tpu_torch.peft import init_prompt_learner, prompt_text_features
from jcf_tpu_torch.tta import build_classifier_weights

torch.set_num_threads(1)

def _weights(blocks):
    """(weight, planes or None) of the four f32 GEMM weights, in
    ``PLANE_WEIGHTS`` order."""
    out = []
    for path in tfg.PLANE_WEIGHTS:
        owner = blocks
        for key in path[:-1]:
            owner = owner[key]
        out.append((owner[path[-1]], owner.get(tfg.planes_key(path[-1]))))
    return out


def _assert_planes(blocks):
    """Each weight's planes are there and equal ``tf32_split_plain`` of
    each of its layers, bit for bit."""
    for w, planes in _weights(blocks):
        assert planes is not None
        assert planes.dtype == torch.float32 and tuple(planes.shape) == (w.shape[0], 2, *w.shape[1:])
        assert planes.device == w.device and planes.is_contiguous()
        for layer in range(w.shape[0]):
            ref = tfg.tf32_split_plain(w[layer])
            assert torch.equal(planes[layer].view(torch.int32), ref.view(torch.int32))


def _same_planes(a, b):
    """The two trees hold the same plane tensors (not copies)."""
    return all(p is q for (_, p), (_, q) in zip(_weights(a), _weights(b)))


def _stacked(rng, layers, e, hidden):
    def n(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x * np.exp2(rng.integers(-30, 30, shape)).astype(np.float32))

    return {"ln_1": {"scale": n(layers, e), "bias": n(layers, e)},
            "attn": {"w_qkv": n(layers, 3 * e, e), "b_qkv": n(layers, 3 * e),
                     "w_out": n(layers, e, e), "b_out": n(layers, e)},
            "ln_2": {"scale": n(layers, e), "bias": n(layers, e)},
            "mlp": {"c_fc": {"w": n(layers, hidden, e), "b": n(layers, hidden)},
                    "c_proj": {"w": n(layers, e, hidden), "b": n(layers, e)}}}


@settings(max_examples=20, deadline=None, derandomize=True)
@given(layers=st.integers(1, 3), e=st.sampled_from([4, 8, 12, 32]),
       hidden=st.sampled_from([4, 16, 24]), seed=st.integers(0, 2**16))
def test_planes_equal_the_split_of_every_layer(layers, e, hidden, seed):
    """Values over 60 binades, zeros of both signs and the ties of the 13
    dropped bits: the planes equal the plain split layer by layer; the
    source dicts are not touched and a second call keeps the planes."""
    rng = np.random.default_rng(seed)
    blocks = _stacked(rng, layers, e, hidden)
    w = blocks["mlp"]["c_fc"]["w"]
    bits = torch.from_numpy(rng.integers(0, 2**23, w.numel(), dtype=np.int64).astype(np.int32))
    ties = ((bits & 0x7FFFE000) | 0x3F801000).view(torch.float32)
    w.view(-1)[:] = torch.where(torch.from_numpy(rng.random(w.numel()) < 0.3), ties, w.view(-1))
    w.view(-1)[:2] = torch.tensor([0.0, -0.0])
    before = {k: dict(v) if isinstance(v, dict) else v for k, v in blocks.items()}
    out = tfg.with_tf32_planes(blocks)
    _assert_planes(out)
    assert all(planes is None for _, planes in _weights(blocks))
    assert blocks["attn"].keys() == before["attn"].keys()
    again = tfg.with_tf32_planes(out)
    assert all(a[1] is b[1] for a, b in zip(_weights(out), _weights(again)))
    # a layer of the tree holds [2, N, K] planes beside each weight
    one = layer_slice(out, layers - 1)
    assert tuple(one["attn"]["w_qkv_tf32"].shape) == (2, 3 * e, e)


def test_planes_take_f32_stacked_weights_only():
    blocks = _stacked(np.random.default_rng(0), 2, 8, 16)
    with pytest.raises(ValueError, match="with_tf32_planes"):
        tfg.with_tf32_planes({**blocks, "attn": {**blocks["attn"],
                                                 "w_qkv": blocks["attn"]["w_qkv"].bfloat16()}})
    with pytest.raises(ValueError, match="with_tf32_planes"):
        tfg.with_tf32_planes(layer_slice(blocks, 0))


# ---------------------------------------------------------------------------
# the float tower with planes against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tower,s", [("visual", 50), ("text", 77)])
def test_float_tower_with_planes_matches_jax(tower, s):
    """``run_float_tower`` in f32 on the tree with planes (as the engine
    and the classifier build hold it) vs ``run_fused_tower(quant=None,
    interpret=True)``: each block within 5e-4, the tower within 1e-3, and
    equal to the planes-free tree's output (the CPU reads the weights)."""
    jp = ft._params(s + 3)
    jblocks, tblocks = ft._blocks(jp, tower)
    planes = tfg.with_tf32_planes(tblocks)
    causal = tower == "text"
    mask = causal_mask(s) if causal else None
    b, e, h = 3, ft.E, ft.H
    x = ft._rows(s + 3, b * s)
    xt = ft._t(x)
    for i in range(tblocks["attn"]["w_qkv"].shape[0]):
        one_j = jax.tree_util.tree_map(lambda a: a[i : i + 1], jblocks)
        one_t = jax.tree_util.tree_map(lambda a: a[i : i + 1], planes)
        ref = ft._jax_tower(xt.numpy().reshape(b, s, e), one_j, h, mask, jnp.float32)
        xt = tbk.run_float_tower(xt, one_t, h, s=s, causal=causal)
        ft._close(xt.numpy(), ref, 5e-4)
    got = tbk.run_float_tower(ft._t(x), planes, h, s=s, causal=causal)
    ft._close(got.numpy(), ft._jax_tower(x.reshape(b, s, e), jblocks, h, mask, jnp.float32), 1e-3)
    assert torch.equal(got, tbk.run_float_tower(ft._t(x), tblocks, h, s=s, causal=causal))


# ---------------------------------------------------------------------------
# the trees made for serving
# ---------------------------------------------------------------------------


def _record_towers(monkeypatch):
    """Records the blocks of every f32 ``run_float_tower`` call that
    ``models.clip`` makes."""
    seen = []
    real = tclip.run_float_tower

    def wrapped(x, blocks, *args, **kw):
        if x.dtype == torch.float32:
            seen.append(blocks)
        return real(x, blocks, *args, **kw)

    monkeypatch.setattr(tclip, "run_float_tower", wrapped)
    return seen


def test_engine_holds_planes_in_f32_only():
    params = tclip.params_from_numpy(ft._params(31))
    cfg = tclip.CLIPConfig(**ft.SMALL)
    f32 = TTAEngine(params, cfg, device="cpu", n_views=2, quant=None)
    _assert_planes(f32._params["visual"]["blocks"])
    assert all(p is None for _, p in _weights(params["visual"]["blocks"]))
    bf16 = TTAEngine(params, cfg, device="cpu", n_views=2, quant=None, dtype=torch.bfloat16)
    assert all(p is None for _, p in _weights(bf16._params["visual"]["blocks"]))


def test_engine_forward_runs_on_its_planes(monkeypatch):
    images, text, geometry = ft._engine_inputs(32)
    params = tclip.params_from_numpy(ft._params(32))
    engine = TTAEngine(params, tclip.CLIPConfig(**ft.SMALL), device="cpu", n_views=ft.N_RANDOM)
    seen = _record_towers(monkeypatch)
    engine.features_from_images(ft._t(images), ft._t(text), geometry=tuple(ft._t(a) for a in geometry))
    assert len(seen) == 1 and _same_planes(seen[0], engine._params["visual"]["blocks"])


@pytest.mark.parametrize("ragged", [False, True])
def test_classifier_builds_split_once_before_the_batches(monkeypatch, ragged):
    """Both paths of ``build_classifier_weights`` (one template count, and
    classes of their own counts) and ``build_text_weights`` split the text
    weights once, then hand the same planes to every 2-prompt batch."""
    kw = dict(ft.SMALL, vocab_size=49408)
    params = tclip.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(6, jclip.CLIPConfig(**kw))))
    templates = {0: ["a photo of a red panda.", "a red panda."],
                 1: ["a photo of a golden eagle.", "an eagle in flight."],
                 2: ["a photo of a striped terrier."] + ([] if ragged else ["a terrier."])}
    splits = []
    real = tfg.with_tf32_planes
    monkeypatch.setattr(tfg, "with_tf32_planes", lambda b: splits.append(1) or real(b))
    import jcf_tpu_torch.tta.classifier as tcls

    monkeypatch.setattr(tcls, "with_tf32_planes", tfg.with_tf32_planes)
    seen = _record_towers(monkeypatch)
    cfg = tclip.CLIPConfig(**kw)
    w = build_classifier_weights(params, cfg, templates, batch_size=2, device="cpu")
    assert w.shape == (3, kw["embed_dim"]) and len(splits) == 1 and len(seen) == 3
    assert all(_same_planes(b, seen[0]) for b in seen)
    _assert_planes(seen[0])
    pc = dataclasses.replace(tconfig.PipelineConfig(),
                             runtime=dataclasses.replace(tconfig.RuntimeConfig(),
                                                         classifier_cache=None))
    seen.clear()
    built = tcommon.build_text_weights(params, cfg, templates, pc, device="cpu")
    assert torch.equal(built, build_classifier_weights(params, cfg, templates, device="cpu"))
    _assert_planes(seen[0])
    assert all(p is None for _, p in _weights(params["text"]["blocks"]))
    seen.clear()
    build_classifier_weights(params, cfg, templates, device="cpu", dtype=torch.bfloat16)
    assert not seen


def test_prompt_learner_splits_its_text_tower(monkeypatch):
    kw = dict(ft.SMALL, vocab_size=49408)
    params = tclip.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(7, jclip.CLIPConfig(**kw))))
    cfg = tclip.CLIPConfig(**kw)
    learner = init_prompt_learner(params, cfg, ["red panda", "eagle"], "a photo of a", 4)
    seen = _record_towers(monkeypatch)
    feats = prompt_text_features(params, cfg, learner)
    assert feats.shape == (2, kw["embed_dim"]) and len(seen) == 1
    _assert_planes(seen[0])
    with_planes = {"text": {**params["text"],
                            "blocks": tfg.with_tf32_planes(params["text"]["blocks"])}}
    seen.clear()
    assert torch.equal(prompt_text_features(with_planes, cfg, learner), feats)
    assert _same_planes(seen[0], with_planes["text"]["blocks"])


@pytest.fixture
def predict_ws(tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        tp._write_workspace(tmp_path)
        yield tmp_path
    finally:
        os.chdir(cwd)


def test_run_predict_splits_the_merged_weights(predict_ws, monkeypatch):
    """``run_predict``'s f32 towers (three classifiers, the prompt learner,
    three engines) each run on planes that are the split of the weights
    they compute with; the prompted and zero-shot towers' weights are the
    LoRA-merged ones, which differ from the checkpoints'."""
    merged = []
    real_merge = tpredict.merge_lora_params
    monkeypatch.setattr(tpredict, "merge_lora_params",
                        lambda *a: merged.append(real_merge(*a)) or merged[-1])
    seen = _record_towers(monkeypatch)
    out = tpredict.run_predict(tp._torch_cfg(tp.ARGV), results_dir="final", device="cpu")
    assert out["n_base"] + out["n_new"] == 6
    # split once each: three classifier builds and the prompt learner on
    # the text towers, three engines on the vision towers
    assert len(merged) == 2 and len({id(b["attn"]["w_qkv_tf32"]) for b in seen}) == 3 + 1 + 3
    for blocks in seen:
        _assert_planes(blocks)
    merged_w = [t[tower]["blocks"]["attn"]["w_qkv"] for t in merged for tower in ("text", "visual")]
    towers_w = [b["attn"]["w_qkv"] for b in seen]
    for w in merged_w:
        assert any(torch.equal(w, t) for t in towers_w)
    raw = tclip.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jclip.init_clip_params(3, jclip.CLIPConfig(**tp.TINY))))
    assert not torch.equal(merged[1]["text"]["blocks"]["attn"]["w_qkv"],
                           raw["text"]["blocks"]["attn"]["w_qkv"])


@pytest.mark.parametrize("encoder", ["text", "vision", "both"])
def test_stage1_step_splits_the_towers_lora_leaves_out(encoder):
    """``make_stage1_step`` in f32: a tower the spec gives no LoRA layer
    runs the fused route, so its frozen blocks carry the planes, split
    from its own weights; a LoRA'd tower (the composable route) and the
    bf16 step's trees carry none. One step runs on each f32 tree."""
    from jcf_tpu_torch.peft import LoraSpec, init_lora_params
    from jcf_tpu_torch.train import adamw, make_stage1_step

    import test_torch_train as tt

    raw, _, banks, images, targets = tt._inputs()
    params, cfg = tt._to_torch(raw), tclip.CLIPConfig(**tt.CFG)
    spec = LoraSpec(**{**tt.SPEC, "encoder": encoder})
    planed = {"text": encoder == "vision", "visual": encoder == "text"}
    init_state, step, frozen = make_stage1_step(params, cfg, spec, torch.from_numpy(banks),
                                                adamw(lr=tt.LR), device="cpu")
    for tower, want in planed.items():
        blocks = frozen[0][tower]["blocks"]
        if want:
            _assert_planes(blocks)
            assert all(torch.equal(w, v) for (w, _), (v, _) in
                       zip(_weights(blocks), _weights(params[tower]["blocks"])))
        else:
            assert all(p is None for _, p in _weights(blocks))
    lora = init_lora_params(1, spec, cfg.text_layers, cfg.text_width, cfg.vision_layers,
                            cfg.vision_width)
    _, m = step(frozen, init_state(lora), torch.from_numpy(images), torch.from_numpy(targets), 0,
                None)
    assert bool(torch.isfinite(m["loss"]))
    _, _, frozen16 = make_stage1_step(params, cfg, spec, torch.from_numpy(banks), adamw(lr=tt.LR),
                                      dtype=torch.bfloat16, device="cpu")
    for tower in planed:
        assert all(p is None for _, p in _weights(frozen16[0][tower]["blocks"]))


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def test_missing_planes_raise_before_a_launch(monkeypatch):
    """The f32 GEMM's and K9b's launch paths refuse a weight without its
    planes (naming ``with_tf32_planes``) or with planes of another shape,
    before they load the kernel library; the halves hand each GEMM its
    planes from the layer."""
    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(tfg._build, "load", no_library)
    monkeypatch.setattr(tbk._build, "load", no_library)
    g = torch.Generator().manual_seed(0)
    a, w, bias = torch.randn(8, 16, generator=g), torch.randn(12, 16, generator=g), torch.zeros(12)
    for epi, extra in (("bias", ()), ("gelu", ()), ("residual", (torch.zeros(8, 12),))):
        with pytest.raises(ValueError, match="with_tf32_planes"):
            tfg._launch(epi, a, w, bias, *extra)
        with pytest.raises(ValueError, match="planes must be"):
            tfg._launch(epi, a, w, bias, *extra, planes=torch.zeros(2, 16, 12))
    blocks = _stacked(np.random.default_rng(1), 1, 64, 256)
    layer = layer_slice(blocks, 0)
    x = torch.randn(2 * 17, 64, generator=g)
    with pytest.raises(ValueError, match="with_tf32_planes"):
        tbk._block_float("block_f32", x, layer, 17, 1, torch.zeros(17, 17), torch.float32)
    short = layer_slice(tfg.with_tf32_planes(blocks), 0)
    short["mlp"] = {**short["mlp"], "c_proj": {**short["mlp"]["c_proj"],
                                                "w_tf32": torch.zeros(2, 64, 255)}}
    with pytest.raises(ValueError, match="planes must be"):
        tbk._block_float("block_f32", x, short, 17, 1, torch.zeros(17, 17), torch.float32)
    handed = []
    monkeypatch.setitem(tbk._GEMMS, torch.float32, tuple(
        (lambda *args, planes=None, f=f: handed.append(planes) or f(*args))
        for f in (tfg.f32_gemm_bias_plain, tfg.f32_gemm_gelu_plain, tfg.f32_gemm_residual_plain)))
    full = layer_slice(tfg.with_tf32_planes(blocks), 0)
    tbk.mlp_half(tbk.attn_half(x, full, 17, 1, causal=True), full)
    expect = [p for _, p in _weights(full)]
    assert len(handed) == 4 and all(p is q for p, q in zip(handed, expect))
