"""The unquantized serving towers of the port (the f32 reference preset
and the bf16 parity configuration): K1's float views, the f32 K6a/K6b
pieces (``ln_affine``, the f32 GEMM epilogues, the causal attention), the
mask-free paired attention in bf16 and f32, the float towers, the f32
``encode_text`` and classifier build, ``TTAEngine(quant=None, dtype=)``,
the presets and the pipeline helpers. The plain versions (what the
wrappers run on CPU tensors) are held against the JAX package's
functions in interpret mode on the same numpy inputs, at 2 layers, width
128 and 4 heads (head dim 32) where the test picks the heads.

Bars: f32 pieces to 1e-5 (the same f32 sums in another order), the f32
towers to 5e-4 per block and 1e-3 at the end; bf16 against JAX's default
CPU run (which keeps bf16 intermediates in f32,
``xla_allow_excess_precision``) with ``tests/test_torch_text.py``'s bars
(row cos >= 0.999, atol = rtol = 5e-2), and against a strict JAX run in a
subprocess (``--xla_allow_excess_precision=false``) to one bf16 ulp on
all but a stated share of elements (a p or t that rounds to bf16 on the
other side of a tie moves its outputs by an ulp)."""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.config as jconfig
import jcf_tpu.ops.block_kernel as jbk
import jcf_tpu.pipelines.common as jcommon
from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
from jcf_tpu.models import clip as jclip
from jcf_tpu.models import loader as jloader
from jcf_tpu.ops.attention import causal_mask
from jcf_tpu.ops.layers import l2_normalize
from jcf_tpu.ops.view_kernel import fused_views_nchw, sample_view_centers
from jcf_tpu.tta import build_classifier_weights as j_build_classifier
from jcf_tpu.tta import solve_mta_batch
from jcf_tpu_torch import config as tconfig
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops import f32_gemm as tfg
from jcf_tpu_torch.ops import view_kernel as tvk
from jcf_tpu_torch.pipelines import common as tcommon

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(
    embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=1000, text_width=128,
    text_heads=4, text_layers=2,
)
E, H = 128, 4  # the towers' width and heads: head dim 32
HI = jax.lax.Precision.HIGHEST


def _params(seed):
    """JAX-initialized params (numpy) with LN affines and biases made
    nonzero in both towers, so every epilogue term is exercised."""
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(seed, jclip.CLIPConfig(**SMALL)))
    rng = np.random.default_rng(seed + 100)
    for tower in ("visual", "text"):
        blocks = jp[tower]["blocks"]
        for ln in ("ln_1", "ln_2"):
            blocks[ln]["scale"] = (1 + 0.1 * rng.standard_normal(blocks[ln]["scale"].shape)).astype(np.float32)
            blocks[ln]["bias"] = (0.1 * rng.standard_normal(blocks[ln]["bias"].shape)).astype(np.float32)
        for leaf in (blocks["attn"], blocks["mlp"]["c_fc"], blocks["mlp"]["c_proj"]):
            for k in [k for k in leaf if k.startswith("b")]:
                leaf[k] = (0.05 * rng.standard_normal(leaf[k].shape)).astype(np.float32)
    return jp


def _ids(seed, b=4):
    """Token ids shaped like tokenized prompts: SOT, words, EOT (the max
    id), zero padding."""
    rng = np.random.default_rng(seed + 7)
    ids = np.zeros((b, SMALL["context_length"]), np.int32)
    for i in range(b):
        n = int(rng.integers(3, 20))
        ids[i, 0] = SMALL["vocab_size"] - 2
        ids[i, 1 : n + 1] = rng.integers(1, SMALL["vocab_size"] - 2, n)
        ids[i, n + 1] = SMALL["vocab_size"] - 1
    return ids


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               atol=atol, rtol=atol)


def _close_bf16(got, ref):
    """``tests/test_torch_text.py``'s bar against a non-strict JAX run."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    cos = ((got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1)
                                  + 1e-9)).min()
    assert cos >= 0.999, cos
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def _within_ulp(got, ref, frac, atol=0.0):
    """|got - ref| <= one bf16 ulp of the larger value + ``atol``, on all
    but ``frac`` of the elements."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    big = np.maximum(np.abs(got), np.abs(ref))
    bad = np.abs(got - ref) > np.ldexp(1.0, np.frexp(np.maximum(big, 1e-30))[1] - 8) + atol
    assert bad.mean() <= frac, bad.mean()


def _rows(seed, n, width=E):
    return np.random.default_rng(seed + 11).standard_normal((n, width)).astype(np.float32)


# ---------------------------------------------------------------------------
# the f32 pieces of K6a / K6b
# ---------------------------------------------------------------------------


def test_plain_ln_affine_f32_matches_jax():
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((77, E)) + 1).astype(np.float32)
    sc = (1 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    b = (0.1 * rng.standard_normal(E)).astype(np.float32)
    ref = _np(jbk._ln_rows(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(b)))
    got = tbk.ln_affine(_t(x), _t(sc), _t(b))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
@pytest.mark.parametrize("k", [128, 512])
def test_plain_f32_gemm_epilogues_match_jax(epilogue, k):
    """The three epilogues against HIGHEST dots + ``_quick_gelu32``."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((77, k)).astype(np.float32)
    w = (rng.standard_normal((96, k)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(96)).astype(np.float32)
    resid = rng.standard_normal((77, 96)).astype(np.float32)
    acc = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(w), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32, precision=HI) + bias
    ref = {"bias": acc, "gelu": jbk._quick_gelu32(acc), "residual": resid + acc}[epilogue]
    args = {"bias": (), "gelu": (), "residual": (_t(resid),)}[epilogue]
    got = getattr(tfg, f"f32_gemm_{epilogue}")(_t(a), _t(w), _t(bias), *args)
    assert got.dtype == torch.float32
    _close(got.numpy(), _np(ref), 1e-5)


def _q3(seed, s, s_pad, g=3, width=E):
    """qkv of g crops, S real rows each, laid out as the TPU pads them
    ([G, S_pad, 3E], garbage in the pad rows) and as the port keeps them
    ([G * S, 3E])."""
    qkv = np.random.default_rng(seed).standard_normal((g, s_pad, 3 * width)).astype(np.float32)
    return qkv, qkv[:, :s].reshape(g * s, 3 * width)


@pytest.mark.parametrize("s", [50, 54, 82, 64])
def test_plain_pair_attention_f32_matches_jax(s):
    """``_paired_attention_nomask`` in f32 at HIGHEST: the shift floored at
    0 where the keys are padded (S = 50, 54, 82), none at S = 64."""
    s_pad = -(-s // 8) * 8
    q3, flat = _q3(s, s, s_pad)
    ref = jbk._paired_attention_nomask(jnp.asarray(q3), H, E // H, 1.0 / np.sqrt(E // H), 3,
                                       s_pad, HI, s_real=s)
    ref = _np(ref).reshape(3, s_pad, E)[:, :s].reshape(3 * s, E)
    got = tbk.pair_attention(_t(flat), s, H)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)


def test_pair_attention_floor_follows_the_padding():
    """Every score negative (k = -4 q): the zeroed pad keys' 0 is the shift
    where S is not a multiple of 8 (S = 50, padded to 56), the pair max
    alone where it is (S = 56); both as JAX computes them, pad rows of
    garbage included."""
    assert tbk._pad_floor(56) == -np.inf and tbk._pad_floor(50) == 0.0
    for s, s_pad in ((50, 56), (56, 56)):
        q3, _ = _q3(5, s, s_pad, g=1)
        q3[..., E : 2 * E] = -4 * q3[..., :E]
        ref = jbk._paired_attention_nomask(jnp.asarray(q3), H, E // H, 1.0 / np.sqrt(E // H), 1,
                                           s_pad, HI, s_real=s)
        got = tbk.pair_attention(_t(q3[0, :s]), s, H)
        _close(got.numpy(), _np(ref)[:s], 1e-5)


def test_plain_causal_attention_f32_matches_jax():
    s, s_pad = 77, 80
    q3, flat = _q3(7, s, s_pad)
    bias = jnp.full((s_pad, s_pad), jbk._NEG_INF, jnp.float32).at[:s, :s].set(causal_mask(s))
    ref = jbk._paired_attention(jnp.asarray(q3), bias, H, E // H, 1.0 / np.sqrt(E // H), 3, s_pad,
                                HI)
    ref = _np(ref).reshape(3, s_pad, E)[:, :s].reshape(3 * s, E)
    got = tbk.causal_attention(_t(flat), s, H)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)


# ---------------------------------------------------------------------------
# K1, float out
# ---------------------------------------------------------------------------


def _view_inputs(seed, b=2, n_views=3, src=(70, 80), out=48):
    images = np.random.default_rng(seed).random((b, 3, *src)).astype(np.float32)
    cy, cx, inv = (np.asarray(a) for a in sample_view_centers(
        jax.random.PRNGKey(seed), b, n_views, src, out))
    return images, cy, cx, inv


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_views_f32_match_jax(seed):
    images, cy, cx, inv = _view_inputs(seed)
    ref = np.asarray(fused_views_nchw(jnp.asarray(images), jnp.asarray(cy), jnp.asarray(cx),
                                      jnp.asarray(inv), 48, interpret=True))
    got = tvk.fused_views_nchw(_t(images), _t(cy), _t(cx), _t(inv), 48)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    _close(got.numpy(), ref, 1e-6)


def test_plain_views_bf16_match_jax():
    images, cy, cx, inv = _view_inputs(2)
    ref = _np(fused_views_nchw(jnp.asarray(images).astype(jnp.bfloat16), jnp.asarray(cy),
                               jnp.asarray(cx), jnp.asarray(inv), 48, interpret=True))
    got = tvk.fused_views_nchw(_t(images, torch.bfloat16), _t(cy), _t(cx), _t(inv), 48)
    assert got.dtype == torch.bfloat16
    # the non-strict JAX run keeps t in f32: two bf16 roundings apart at most
    _within_ulp(got.float().numpy(), ref, 0.0, atol=2.0**-8)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def _blocks(jp, tower):
    return jp[tower]["blocks"], tclip.params_from_numpy(jp)[tower]["blocks"]


def _jax_tower(x, jblocks, n_heads, mask, dtype):
    b, s, e = x.shape
    return _np(jbk.run_fused_tower(jnp.asarray(x).astype(dtype), jblocks, n_heads, mask,
                                   interpret=True)).reshape(b * s, e)


@pytest.mark.parametrize("tower,s", [("visual", 50), ("visual", 54), ("visual", 82),
                                     ("visual", 64), ("text", 77)])
def test_f32_tower_matches_jax_per_block_and_end(tower, s):
    """``run_float_tower`` in f32 vs ``run_fused_tower(quant=None,
    interpret=True)``: each block on the same input within 5e-4, the whole
    tower within 1e-3."""
    jp = _params(s)
    jblocks, tblocks = _blocks(jp, tower)
    causal = tower == "text"
    mask = causal_mask(s) if causal else None
    b = 3
    x = _rows(s, b * s)
    xt = _t(x)
    for i in range(SMALL["vision_layers"]):
        one_j = jax.tree_util.tree_map(lambda a: a[i : i + 1], jblocks)
        one_t = jax.tree_util.tree_map(lambda a: a[i : i + 1], tblocks)
        ref = _jax_tower(xt.numpy().reshape(b, s, E), one_j, H, mask, jnp.float32)
        xt = tbk.run_float_tower(xt, one_t, H, s=s, causal=causal)
        _close(xt.numpy(), ref, 5e-4)
    ref = _jax_tower(x.reshape(b, s, E), jblocks, H, mask, jnp.float32)
    got = tbk.run_float_tower(_t(x), tblocks, H, s=s, causal=causal)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-3)


@pytest.mark.parametrize("tower,s", [("visual", 50), ("text", 77)])
def test_bf16_tower_matches_jax(tower, s):
    jp = _params(s + 1)
    jblocks, tblocks = _blocks(jp, tower)
    causal = tower == "text"
    x = _rows(s + 1, 3 * s)
    ref = _jax_tower(x.reshape(3, s, E), jblocks, H, causal_mask(s) if causal else None,
                     jnp.bfloat16)
    got = tbk.run_float_tower(_t(x, torch.bfloat16), tblocks, H, s=s, causal=causal)
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), ref)


_JAX_STRICT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.ops.view_kernel import fused_views_nchw
d = np.load(sys.argv[1], allow_pickle=True).item()
bf = jnp.bfloat16
out = {}
for s, q3 in d["q3"].items():
    g, s_pad, e3 = q3.shape
    e = e3 // 3
    r = jbk._paired_attention_nomask(jnp.asarray(q3).astype(bf), d["H"], e // d["H"],
                                     1.0 / np.sqrt(e // d["H"]), g, s_pad, s_real=s)
    out[f"attn{s}"] = np.asarray(r.astype(bf).astype(jnp.float32))
v = d["views"]
out["views"] = np.asarray(fused_views_nchw(jnp.asarray(v[0]).astype(bf), *(jnp.asarray(a) for a in v[1:]),
                                           48, interpret=True).astype(jnp.float32))
x = jnp.asarray(d["x"]).astype(bf)
out["tower"] = np.asarray(jbk.run_fused_tower(x, d["blocks"], d["H"], None, interpret=True)
                          .astype(jnp.float32))
np.save(sys.argv[2], out, allow_pickle=True)
"""


def test_strict_bf16_matches_jax(tmp_path):
    """With XLA's excess precision off both sides round p, t and every
    cast point to bf16: the mask-free attention at S = 50, 54, 82 and 64
    and K1's bf16 views agree to one bf16 ulp on all but 1e-3 of the
    elements; the 2-layer vision tower to row cos >= 0.9999 and 2e-2."""
    pad = {s: -(-s // 8) * 8 for s in (50, 54, 82, 64)}
    q3 = {s: _q3(s + 3, s, pad[s])[0] for s in pad}
    views = _view_inputs(4)
    jp = _params(9)
    x = _rows(9, 3 * 50).reshape(3, 50, E)
    np.save(tmp_path / "in.npy", {"q3": q3, "H": H, "views": views, "x": x,
                                  "blocks": jp["visual"]["blocks"]}, allow_pickle=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_STRICT, str(tmp_path / "in.npy"),
                    str(tmp_path / "out.npy")], cwd=ROOT, env=env, check=True, timeout=600)
    ref = np.load(tmp_path / "out.npy", allow_pickle=True).item()
    for s, q in q3.items():
        flat = q[:, :s].reshape(-1, 3 * E)
        got = tbk.pair_attention(_t(flat, torch.bfloat16), s, H).float().numpy()
        want = ref[f"attn{s}"].reshape(3, pad[s], E)[:, :s].reshape(-1, E)
        _within_ulp(got, want, 1e-3)
    images, cy, cx, inv = views
    got = tvk.fused_views_nchw(_t(images, torch.bfloat16), _t(cy), _t(cx), _t(inv), 48)
    _within_ulp(got.float().numpy(), ref["views"], 1e-3)
    got = tbk.run_float_tower(_t(x.reshape(-1, E), torch.bfloat16),
                              tclip.params_from_numpy(jp)["visual"]["blocks"], H, s=50,
                              causal=False).float().numpy()
    want = ref["tower"].reshape(-1, E)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999, cos.min()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_block_route_bf16_and_f32_refusal(monkeypatch):
    """Under ``_FUSE = "block"`` the bf16 vision tower runs K9b with an
    all-zero bias, as the JAX package runs ``_block_kernel`` with its pad
    keys masked; the f32 tower, once refused, now runs K9b in f32
    (``block_f32``) and is held against the JAX tower in f32."""
    monkeypatch.setattr(tbk, "_FUSE", "block")
    monkeypatch.setattr(jbk, "_FUSE", "block")
    jp = _params(21)
    jblocks, tblocks = _blocks(jp, "visual")
    x = _rows(21, 3 * 50)
    calls = []
    block = tbk.block_bf16
    monkeypatch.setattr(tbk, "block_bf16", lambda *a: calls.append(a[4]) or block(*a))
    got = tbk.run_float_tower(_t(x, torch.bfloat16), tblocks, H, s=50, causal=False)
    assert len(calls) == 2 and not bool(calls[0].any())
    _close_bf16(got.float().numpy(), _jax_tower(x.reshape(3, 50, E), jblocks, H, None, jnp.bfloat16))
    got = tbk.run_float_tower(_t(x), tblocks, H, s=50, causal=False)
    assert got.dtype == torch.float32
    _close(got.numpy(), _jax_tower(x.reshape(3, 50, E), jblocks, H, None, jnp.float32), 1e-3)


def test_encode_text_f32_matches_jax():
    jp = _params(5)
    ids = _ids(5)
    cfg = jclip.CLIPConfig(**SMALL)
    ref = _np(jclip.encode_text(jp, cfg, jnp.asarray(ids), dtype=jnp.float32, impl="fused"))
    got = tclip.encode_text(tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL), ids,
                            device="cpu", dtype=torch.float32)
    assert got.shape == (4, SMALL["embed_dim"]) and got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-3)


def test_f32_classifier_build_matches_jax(tmp_path):
    """``build_text_weights(PipelineConfig())`` (f32, no cache) vs the JAX
    package's f32 classifier through its fused text tower."""
    kw = dict(SMALL, vocab_size=49408)  # the tokenizer's vocabulary
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(6, jclip.CLIPConfig(**kw)))
    templates = {0: ["a photo of a red panda.", "a red panda."],
                 1: ["a photo of a golden eagle.", "an eagle in flight."],
                 2: ["a photo of a striped terrier.", "a terrier."]}
    pc = dataclasses.replace(tconfig.PipelineConfig(),
                             runtime=dataclasses.replace(tconfig.RuntimeConfig(),
                                                         classifier_cache=None))
    got = tcommon.build_text_weights(tclip.params_from_numpy(jp), tclip.CLIPConfig(**kw),
                                     templates, pc, device="cpu")
    ref = _np(j_build_classifier(jax.tree_util.tree_map(jnp.asarray, jp), jclip.CLIPConfig(**kw),
                                 templates, dtype=jnp.float32, impl="fused"))
    assert got.dtype == torch.float32 and got.shape == (3, SMALL["embed_dim"])
    _close(got.numpy(), ref, 1e-3)
    assert tcommon.compute_dtype(tconfig.PipelineConfig()) == torch.float32
    assert tcommon.compute_dtype(tconfig.perf_preset()) == torch.bfloat16


# ---------------------------------------------------------------------------
# the unquantized engines
# ---------------------------------------------------------------------------

B, SRC, N_RANDOM, CLASSES = 3, 72, 3, 10


def _jax_engine(jp, images, geometry, text, dtype):
    """The JAX engine's float route (engine.py features_from_images_spec,
    fused views, ``embed_impl="conv"``; encode_image_tokens through the
    fused tower), composed in interpret mode."""
    cfg = jclip.CLIPConfig(**SMALL)
    res, p, g = cfg.image_resolution, cfg.vision_patch_size, cfg.grid_size
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtype) if a.dtype == np.float32 else a, jp)
    w4f, fb = jclip.fold_normalize_into_embed(jp["visual"]["patch_embed"]["w"], CLIP_MEAN, CLIP_STD, p)
    kern = jnp.transpose(w4f.astype(dtype), (3, 0, 1, 2))
    cy, cx, inv = (jnp.asarray(a) for a in geometry)
    b, n = cy.shape[:2]
    views = fused_views_nchw(jnp.asarray(images).astype(dtype), cy, cx, inv, res, interpret=True)
    acc = jax.lax.conv_general_dilated(views.reshape(b * n, 3, res, res), kern, (p, p), "VALID",
                                       dimension_numbers=("NCHW", "OIHW", "NHWC"),
                                       preferred_element_type=jnp.float32)
    tokens = acc.reshape(b * n, g * g, -1) + fb
    feats = jclip.encode_image_tokens(params, cfg, tokens, dtype=dtype, impl="fused")
    feats = l2_normalize(feats).reshape(b, n, -1).astype(jnp.float32)
    return np.asarray(solve_mta_batch(feats, jnp.asarray(text)))


def _engine_inputs(seed):
    rng = np.random.default_rng(seed)
    images = rng.random((B, 3, SRC, SRC)).astype(np.float32)
    text = rng.standard_normal((CLASSES, SMALL["embed_dim"])).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    geometry = [np.array(a) for a in sample_view_centers(
        jax.random.PRNGKey(seed), B, N_RANDOM + 1, (SRC, SRC), SMALL["image_resolution"])]
    return images, text, geometry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unquantized_engine_matches_jax(dtype, monkeypatch):
    """``TTAEngine(quant=None, dtype=)``'s ``features_from_images`` vs the
    JAX engine's float route on the same weights, images, geometry and
    classifier; the tower takes the fused route (the mask-free pair
    attention on every layer, no K7)."""
    jp = _params(11)
    images, text, geometry = _engine_inputs(11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = _jax_engine(jp, images, geometry, text, jdt)
    engine = TTAEngine(tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL), device="cpu",
                       n_views=N_RANDOM, quant=None, dtype=tdt)
    calls = []
    pair = tbk.pair_attention
    monkeypatch.setattr(tbk, "pair_attention", lambda *a: calls.append(a[0].dtype) or pair(*a))
    got = engine.features_from_images(_t(images), _t(text),
                                      geometry=tuple(_t(a) for a in geometry)).numpy()
    assert calls == [tdt] * SMALL["vision_layers"]
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= (0.99999 if dtype == "float32" else 0.999), cos
    np.testing.assert_array_equal((got @ text.T).argmax(-1), (ref @ text.T).argmax(-1))


def test_unquantized_engine_crops_match_jax():
    """``features_from_crops`` of the f32 engine (the reference preset's
    parity path) vs the JAX engine's ``_encode_cloud`` + MTA."""
    jp = _params(12)
    rng = np.random.default_rng(12)
    crops = rng.standard_normal((2, 4, 3, 64, 64)).astype(np.float32)
    text = rng.standard_normal((CLASSES, SMALL["embed_dim"])).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    cfg = jclip.CLIPConfig(**SMALL)
    feats = jclip.encode_image(jp, cfg, jnp.asarray(crops.reshape(8, 3, 64, 64)),
                               dtype=jnp.float32, impl="fused")
    ref = np.asarray(solve_mta_batch(l2_normalize(feats).reshape(2, 4, -1), jnp.asarray(text)))
    engine = TTAEngine(tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL), device="cpu",
                       quant=None)
    got = engine.features_from_crops(_t(crops), _t(text)).numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.99999, cos


def test_engine_dtype_rules():
    params = tclip.init_clip_params(0, tclip.CLIPConfig(**SMALL))
    cfg = tclip.CLIPConfig(**SMALL)
    assert TTAEngine(params, cfg, device="cpu", quant=None).dtype == torch.float32
    assert TTAEngine(params, cfg, device="cpu", quant=None, dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        TTAEngine(params, cfg, device="cpu", quant="int8", dtype=torch.float32)
    with pytest.raises(ValueError):
        TTAEngine(params, cfg, device="cpu", quant=None, dtype=torch.float16)


# ---------------------------------------------------------------------------
# presets and pipeline helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", ["PipelineConfig", "perf_preset", "reference_preset"])
def test_presets_match_jax(make):
    """Field by field: every field the port keeps has the JAX value in the
    default config and both presets; the TTA section is ported whole."""
    t, j = getattr(tconfig, make)(), getattr(jconfig, make)()
    assert ([f.name for f in dataclasses.fields(t.tta)]
            == [f.name for f in dataclasses.fields(j.tta)])
    for section in ("data", "runtime", "lora", "stage1", "tta"):
        for f in dataclasses.fields(getattr(t, section)):
            assert getattr(getattr(t, section), f.name) == getattr(getattr(j, section), f.name), \
                (section, f.name)


@pytest.mark.parametrize("make", ["reference_preset", "perf_preset", "perf_preset_host_crops"])
def test_build_engine_reads_the_config(make):
    """``build_engine`` builds the engine ``jcf_tpu/pipelines/ood.py:47-61``
    builds from the same config: the reference preset's f32 unquantized
    engine; the perf preset's int8 engine with static "full" scales
    calibrated on the first batch (and a refusal without it); static_quant
    off the device-crop path keeps dynamic scales."""
    pc = tconfig.reference_preset() if make == "reference_preset" else tconfig.perf_preset()
    if make == "perf_preset_host_crops":
        pc = dataclasses.replace(pc, tta=dataclasses.replace(pc.tta, device_crops=False))
    params = tclip.init_clip_params(0, tclip.CLIPConfig(**SMALL))
    batch = torch.from_numpy(_engine_inputs(13)[0])
    engine = tcommon.build_engine(params, tclip.CLIPConfig(**SMALL), pc, batch, device="cpu")
    assert (engine.quant, engine.n_views, engine.crop_scale) == (
        pc.runtime.quant, pc.tta.n_views, pc.tta.crop_scale)
    assert engine.dtype == tcommon.compute_dtype(pc)
    if make == "reference_preset":
        assert (engine.quant, engine.dtype, engine.n_views) == (None, torch.float32, 512)
        return
    static = make == "perf_preset"
    assert all((k in engine._quant[part]) == static
               for part, k in (("attn", "ln_inv"), ("attn", "ctx_inv"), ("mlp", "h_inv")))
    if static:
        with pytest.raises(ValueError, match="first_batch"):
            tcommon.build_engine(params, tclip.CLIPConfig(**SMALL), pc, device="cpu")


def test_load_model_for_pipeline_matches_jax(tmp_path):
    """A checkpoint through ``load_model_for_pipeline``, plain and with
    ``prompted`` (4 fresh visual prompt tokens drawn as JAX draws them)."""
    kw = dict(SMALL, vision_layers=1, text_layers=1)
    jp = jclip.init_clip_params(3, jclip.CLIPConfig(**kw))
    sd = {k: np.asarray(v) for k, v in
          jloader.state_dict_from_params(jp, jclip.CLIPConfig(**kw)).items()}
    path = str(tmp_path / "clip.pkl")
    with open(path, "wb") as f:
        pickle.dump(sd, f)
    for prompted in (False, True):
        tpc = dataclasses.replace(tconfig.PipelineConfig(), runtime=dataclasses.replace(
            tconfig.RuntimeConfig(), clip_checkpoint=path))
        jpc = dataclasses.replace(jconfig.PipelineConfig(), runtime=dataclasses.replace(
            jconfig.RuntimeConfig(), clip_checkpoint=path))
        params, mcfg = tcommon.load_model_for_pipeline(tpc, prompted=prompted)
        ref_params, ref_cfg = jcommon.load_model_for_pipeline(jpc, prompted=prompted)
        assert dataclasses.asdict(mcfg) == dataclasses.asdict(ref_cfg)
        assert ("vpt" in params["visual"]) == prompted == (mcfg.vision_prompt_tokens == 4)
        np.testing.assert_array_equal(params["visual"]["proj"].numpy(),
                                      np.asarray(ref_params["visual"]["proj"]))
        if prompted:
            np.testing.assert_array_equal(params["visual"]["vpt"].numpy(),
                                          np.asarray(ref_params["visual"]["vpt"]))


def test_stack_center_and_crops_matches_jax():
    rng = np.random.default_rng(0)
    center = rng.standard_normal((2, 1, 3, 8, 8)).astype(np.float32)
    crops = rng.standard_normal((2, 5, 3, 8, 8)).astype(np.float32)
    got = tcommon.stack_center_and_crops(center, crops)
    assert got.shape == (2, 6, 3, 8, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcommon.stack_center_and_crops(center, crops)))
    np.testing.assert_array_equal(got[:, 0].numpy(), center[:, 0])
