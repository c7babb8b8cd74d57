"""The whole-layer int8 kernels K9a (``block_int8``), K9d
(``layer_fused_int8``) and K9c (``stream_tower_int8``) off the folded
dense route at 64 tokens or fewer: the unfolded tree on the dense route
(branch A), the masked attention of the text tower and of an odd head
count, on bf16 and f32 rows (branch B), the mask-free non-dense route at
S a multiple of 16 (branch C), and the folded dense route at 65 to 127
tokens (branch D). The port's plain versions against the JAX kernels in
interpret mode (``fused_block`` under ``_FUSE`` = "block",
``_layer_block``, ``_stream_tower``, ``run_fused_tower``), with
``_FUSE``, ``_MLP_NSPLIT`` and ``_LAYER_NSPLIT`` set on both packages by
monkeypatch, on the same seeded numpy inputs at width 128 with 2 heads of
64 (192 with 3 heads for the odd count); then ``encode_text(quant=)``,
the int8 classifier and the int8 engine's odd-head and 64-token towers
(its non-assembled route) under "block".

Bars (``tests/test_torch_masked_int8.py``'s): one layer within 0.05 +
0.05 |ref| everywhere at row cos >= 0.999, on bf16 and f32 rows alike
(an int8 value flips at a rounding tie where the two sides' f32 sums
differ in the last bits); towers, text features, classifiers and engine
modes at row cos >= 0.999 (ties compound over layers). K9c equals its
layers run one by one through K9d's plain body bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
import test_torch_masked_int8 as mi
import test_torch_quant_modes as qm
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import quant as jquant
from jcf_tpu.ops.attention import causal_mask
from jcf_tpu.ops.layers import l2_normalize
from jcf_tpu.tta import build_classifier_weights as j_build
from jcf_tpu.tta import solve_mta_batch
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops import quant as tquant
from jcf_tpu_torch.ops.layers import layer_slice
from jcf_tpu_torch.tta import classifier as tcls

torch.set_num_threads(1)

CROPS = 2


@pytest.fixture
def knobs(monkeypatch):
    """Sets ``_FUSE`` and the chunk counts on both packages for the test."""
    def set_(fuse, **counts):
        for mod in (jbk, tbk):
            monkeypatch.setattr(mod, "_FUSE", fuse)
            for name, value in counts.items():
                monkeypatch.setattr(mod, name, value)
    return set_


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert mi._row_cos(got, ref) >= 0.999, mi._row_cos(got, ref)
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def _pad16(s):
    return -(-s // 16) * 16


# the branches' trees: (name) -> (tower, folded, mode, heads, S, causal, rows dtype)
BRANCHES = {
    "A unfolded dense": ("visual", False, None, 2, 50, False, torch.bfloat16),
    "B causal f32 unfolded": ("text", False, None, 2, 77, True, torch.float32),
    "B causal f32 folded": ("text", True, None, 2, 77, True, torch.float32),
    "B causal bf16 unfolded": ("text", False, None, 2, 17, True, torch.bfloat16),
    "B causal bf16 folded full": ("text", True, "full", 2, 77, True, torch.bfloat16),
    "B odd heads unfolded": ("visual", False, None, 3, 17, False, torch.bfloat16),
    "B odd heads folded full": ("visual", True, "full", 3, 50, False, torch.bfloat16),
    "C S = 64 unfolded": ("visual", False, None, 2, 64, False, torch.bfloat16),
    "C S = 64 folded full+score": ("visual", True, "full+score", 2, 64, False, torch.bfloat16),
    "D 82 tokens full": ("visual", True, "full", 2, 82, False, torch.bfloat16),
    "D 82 tokens dynamic": ("visual", True, None, 2, 82, False, torch.bfloat16),
}


def _amax(n_layers, with_scores):
    """A made-up calibration in ``vision_ln_z_amax``'s columns: the LN1 and
    LN2 z-norm, context and hidden amax, and with scores the score amax 43
    + i and a weakest row max of 1 (layer i's shift about 1)."""
    a = np.tile(np.array([4.0, 4.5, 0.6, 3.0], np.float32), (n_layers, 1))
    if with_scores:
        extra = np.stack([43.0 + np.arange(n_layers), np.ones(n_layers)], axis=1)
        a = np.concatenate([a, extra.astype(np.float32)], axis=1)
    return a


def _branch(name, seed=0):
    """(JAX blocks, JAX tree, port blocks, port tree, heads, S, causal,
    dtype, E) of a branch: the trees of one set of numpy params, folded in
    the branch's mode (a static mode from a made-up calibration, as both
    packages take it) or unfolded."""
    tower, folded, mode, n_heads, s, causal, dtype = BRANCHES[name]
    jp = mi._params(seed, 64 * n_heads)
    e = 64 * n_heads if tower == "visual" else mi.E
    if mode is None:
        jb, jq, tb, tq = mi._tower(jp, tower, folded, n_heads)
        return jb, jq, tb, tq, n_heads, s, causal, dtype, e
    act_static, with_scores = qm._jax_act_static(mode)
    heads = {"visual": n_heads, "text": mi.H}  # both towers fold; text 2 heads of 64
    amax = _amax(jp[tower]["blocks"]["ln_1"]["scale"].shape[0], with_scores)
    jq = jquant.quantize_clip_params(jp, fold=True, heads=heads, act_scales={tower: amax},
                                     act_static=act_static)[tower]
    tp = tclip.params_from_numpy(jp)
    tq = tquant.quantize_clip_params(tp, fold=True, heads=heads,
                                     act_scales={tower: torch.from_numpy(amax)},
                                     act_static=act_static)[tower]
    return jp[tower]["blocks"], jq, tp[tower]["blocks"], tq, n_heads, s, causal, dtype, e


def _route(n_heads, s, causal):
    """(dense, the reference's s_pad) of ``run_fused_tower``'s route."""
    dense = not causal and n_heads % 2 == 0 and s % 16 != 0
    return dense, (_pad16(s) if dense else mi._pad8(s))


def _lns(tb, folded, i, dtype):
    if folded:
        return None, None
    return tuple(tbk._layer_ln(tb, i, n, dtype) for n in ("ln_1", "ln_2"))


def _stacked_lns(tb, folded, dtype):
    if folded:
        return None, None
    return tuple({k: tb[n][k].to(dtype) for k in ("scale", "bias")} for n in ("ln_1", "ln_2"))


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("name", list(BRANCHES))
def test_block_int8_matches_jax(knobs, name, nsp):
    """K9a, one layer on every row of its route: ``fused_block`` under
    "block" on the reference's layout (dense flat rows, or the padded [B,
    S_pad, E] with its additive bias)."""
    knobs("block", _MLP_NSPLIT=nsp)
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = _branch(name)
    folded = tq["quant_folded"]
    dense, s_pad = _route(n_heads, s, causal)
    x = mi._rows(1, CROPS * s, e, dtype)
    i = 1
    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]), jb)
    lq = jax.tree_util.tree_map(lambda a: a[i], jq)
    xj = mi._jx(x) if dense else mi._padded(x, s, s_pad)
    ref = jbk.fused_block(xj, lp, n_heads, mi._bias(s, s_pad, causal), quant_layer=lq,
                          interpret=True, s_real=s, use_mask=causal or n_heads % 2 == 1,
                          quant_folded=folded, dense=dense, s_pad=s_pad)
    got = tbk.block_int8(x, layer_slice(tq, i), s, n_heads, lns=_lns(tb, folded, i, dtype),
                         causal=causal, dense=dense)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got.float().numpy(), mi._np(ref) if dense else mi._unpad(ref, s))


DENSE = ["A unfolded dense", "D 82 tokens full", "D 82 tokens dynamic"]


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("name", DENSE)
def test_layer_fused_int8_matches_jax(knobs, name, nsp):
    """K9d, one layer of the dense route: ``_layer_block``."""
    knobs("layer", _LAYER_NSPLIT=nsp)
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = _branch(name)
    folded = tq["quant_folded"]
    x = mi._rows(2, CROPS * s, e, dtype)
    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jb)
    lq = jax.tree_util.tree_map(lambda a: a[0], jq)
    ref = jbk._layer_block(mi._jx(x), lp, n_heads, lq, True, s_real=s, s_pad=_pad16(s),
                           quant_folded=folded)
    got = tbk.layer_fused_int8(x, layer_slice(tq, 0), s, n_heads, lns=_lns(tb, folded, 0, dtype))
    _close(got.float().numpy(), mi._np(ref))


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("name", DENSE)
def test_stream_tower_int8_matches_jax(knobs, name, nsp):
    """K9c: both layers of the dense route in one call, ``_stream_tower``;
    and bit for bit its layers one by one through K9d's plain body."""
    knobs("stream", _MLP_NSPLIT=nsp, _LAYER_NSPLIT=nsp)
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = _branch(name)
    folded = tq["quant_folded"]
    x = mi._rows(3, CROPS * s, e, dtype)
    ref = jbk._stream_tower(mi._jx(x), jax.tree_util.tree_map(jnp.asarray, jb), jq, n_heads,
                            qm._bias(s), s_real=s, s_pad=_pad16(s), interpret=True,
                            quant_folded=folded)
    got = tbk.stream_tower_int8(x, tq, n_heads, s=s, lns=_stacked_lns(tb, folded, dtype))
    _close(got.float().numpy(), mi._np(ref))
    by_layer = x
    for i in range(2):
        by_layer = tbk.layer_fused_int8(by_layer, layer_slice(tq, i), s, n_heads,
                                        lns=_lns(tb, folded, i, dtype))
    assert torch.equal(got, by_layer)


# (name, _FUSE) of the towers: every branch under "block", the dense ones
# under "layer" and "stream" too
TOWERS = ([(n, "block") for n in BRANCHES]
          + [(n, f) for n in DENSE for f in ("layer", "stream")]
          + [("B causal bf16 unfolded", "layer"), ("C S = 64 unfolded", "stream")])


@pytest.mark.parametrize("cls_only", [True, False])
@pytest.mark.parametrize("name,fuse", TOWERS)
def test_tower_matches_jax(knobs, name, fuse, cls_only):
    """``run_fused_tower`` (2 layers) vs the JAX function under the same
    ``_FUSE``, tree, mask and ``cls_only`` (the non-dense routes run the
    halves under "layer" and "stream" on both sides)."""
    knobs(fuse)
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = _branch(name)
    x = mi._rows(4, CROPS * s, e, dtype)
    ref = jbk.run_fused_tower(mi._jx(x), jax.tree_util.tree_map(jnp.asarray, jb), n_heads,
                              causal_mask(s) if causal else None, quant=jq,
                              quant_folded=tq["quant_folded"], interpret=True, flat_s=s,
                              cls_only=cls_only)
    got = tbk.run_fused_tower(x, tq, n_heads, flat_s=s, cls_only=cls_only, blocks=tb,
                              causal=causal)
    assert got.dtype == dtype and got.shape == ((CROPS, e) if cls_only else (CROPS * s, e))
    assert mi._row_cos(got.float().numpy(), mi._np(ref).reshape(got.shape)) >= 0.999


def test_block_route_runs_k9a_on_every_branch(knobs):
    """Under "block" every layer of every branch is one ``block_int8`` (no
    halves); the dense route's last layer keeps the CLS gate: K5 + K4 at S
    <= 64, K3 + K4 on the CLS rows from 65 tokens on."""
    knobs("block")
    calls = []
    for name in BRANCHES:
        jb, jq, tb, tq, n_heads, s, causal, dtype, e = _branch(name)
        dense, _ = _route(n_heads, s, causal)
        x = mi._rows(5, CROPS * s, e, dtype)
        seen = {}
        with pytest.MonkeyPatch.context() as m:
            for fn in ("block_int8", "attn_half_int8", "mlp_half_int8", "attn_cls_int8"):
                orig = getattr(tbk, fn)

                def spy(*a, _fn=fn, _orig=orig, **k):
                    seen[_fn] = seen.get(_fn, 0) + 1
                    return _orig(*a, **k)
                m.setattr(tbk, fn, spy)
            tbk.run_fused_tower(x, tq, n_heads, flat_s=s, blocks=tb, causal=causal)
        want = ({"block_int8": 1, "attn_cls_int8": 1, "mlp_half_int8": 1} if dense and s <= 64
                else {"block_int8": 1, "attn_half_int8": 1, "mlp_half_int8": 1} if dense
                else {"block_int8": 2})
        calls.append((name, seen == want))
    assert all(ok for _, ok in calls), calls


def test_k9_branch_names():
    """``k9_branch`` names the branch each launch is counted under."""
    for name, want in (("A unfolded dense", "unfolded"), ("B causal f32 folded", "masked_f32"),
                       ("B causal bf16 unfolded", "masked"), ("B odd heads folded full", "masked"),
                       ("C S = 64 unfolded", "nondense"), ("D 82 tokens full", "long")):
        _, _, _, tq, n_heads, s, causal, dtype, _ = _branch(name)
        dense, _ = _route(n_heads, s, causal)
        assert tbk.k9_branch(tq, s, n_heads, dtype, causal=causal, dense=dense) == want
    _, _, _, tq, _, _, _, _, _ = _branch("D 82 tokens full")
    assert tbk.k9_branch(tq, 50, 2, torch.bfloat16) == ""


def test_wrappers_refuse_a_tree_and_route_that_do_not_match():
    """An unfolded tree without its LN affines (or a folded one with
    them), and the dense route with a mask or an odd head count, raise
    before anything runs."""
    _, _, tb, tq, n_heads, s, _, dtype, e = _branch("A unfolded dense")
    x = mi._rows(6, CROPS * s, e, dtype)
    layer = layer_slice(tq, 0)
    for fn in (tbk.block_int8, tbk.layer_fused_int8):
        with pytest.raises(ValueError, match="lns"):
            fn(x, layer, s, n_heads)
    with pytest.raises(ValueError, match="lns"):
        tbk.stream_tower_int8(x, tq, n_heads, s=s)
    _, _, _, fq, _, _, _, _, _ = _branch("D 82 tokens full")
    with pytest.raises(ValueError, match="lns"):
        tbk.block_int8(x, layer_slice(fq, 0), s, n_heads, lns=_lns(tb, False, 0, dtype))
    with pytest.raises(ValueError, match="dense route"):
        tbk.block_int8(x, layer_slice(fq, 0), s, n_heads, causal=True)
    with pytest.raises(ValueError, match="dense route"):
        tbk.layer_fused_int8(mi._rows(6, CROPS * s, 192), layer_slice(
            _branch("B odd heads folded full")[3], 0), s, 3)


# ---------------------------------------------------------------------------
# the int8 text tower and classifier, the int8 engine's non-assembled route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_text_int8_under_block_matches_jax(knobs, dtype):
    """``encode_text(quant=)`` under "block" (K9a per layer, masked) vs the
    JAX function's fused route under "block"."""
    knobs("block")
    jp = mi._params(5)
    ids = mi._ids(5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = mi._np(jclip.encode_text(jp, jclip.CLIPConfig(**mi._cfg()), jnp.asarray(ids), dtype=jdt,
                                   impl="fused", quant=jquant.quantize_clip_params(jp)["text"]))
    tp = tclip.params_from_numpy(jp)
    got = tclip.encode_text(tp, tclip.CLIPConfig(**mi._cfg()), ids, device="cpu", dtype=dtype,
                            quant=tquant.quantize_clip_params(tp)["text"])
    assert got.dtype == dtype and got.shape == (4, 32)
    assert mi._row_cos(got.float().numpy(), ref) >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_classifier_under_block_matches_jax(knobs, dtype):
    """``build_classifier_weights(quant=)`` under "block" vs the JAX
    package's under "block", and against the f32 classifier at cos > 0.99
    (the JAX certificate)."""
    knobs("block")
    jp = mi._params(6, vocab=49408)
    templates = {i: [f"a photo of a {n}.", f"a {n}."] for i, n in enumerate(mi.NAMES)}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    cfg = mi._cfg(vocab=49408)
    ref = mi._np(j_build(jax.tree_util.tree_map(jnp.asarray, jp), jclip.CLIPConfig(**cfg),
                         templates, dtype=jdt, impl="fused",
                         quant=jquant.quantize_clip_params(jp)["text"]))
    tp = tclip.params_from_numpy(jp)
    got = tcls.build_classifier_weights(tp, tclip.CLIPConfig(**cfg), templates, device="cpu",
                                        dtype=dtype, quant=tquant.quantize_clip_params(tp)["text"])
    assert got.dtype == dtype and got.shape == (len(mi.NAMES), 32)
    assert mi._row_cos(got.float().numpy(), ref) >= 0.999
    f32 = tcls.build_classifier_weights(tp, tclip.CLIPConfig(**cfg), templates, device="cpu")
    assert mi._row_cos(got.float().numpy(), f32.numpy()) > 0.99


def _engine_cfg(width, prompts):
    """One layer at patch 32, 224²: 50 tokens, 64 with 14 visual prompts."""
    return dict(qm._cfg(224, layers=1, width=width), vision_prompt_tokens=prompts)


def _jax_tokens_modes(jp, cfg, images, geometry, text, jq):
    """The JAX engine's non-assembled int8 route (engine.py:636-680),
    composed from its functions: int8 views, the s32 patch GEMM, tokens
    acc * k_scale + k_bias in f32, then ``encode_image_tokens`` in bf16 on
    the folded tree (the fused tower in interpret mode), MTA."""
    from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
    from jcf_tpu.ops.view_kernel import fused_views_nchw

    c = jclip.CLIPConfig(**cfg)
    res, p, g = c.image_resolution, c.vision_patch_size, c.grid_size
    w4f, fb = jclip.fold_normalize_into_embed(jp["visual"]["patch_embed"]["w"], CLIP_MEAN,
                                              CLIP_STD, p)
    flat = jnp.transpose(w4f, (3, 0, 1, 2)).reshape(w4f.shape[3], -1)
    kscale = jnp.maximum(jnp.max(jnp.abs(flat), axis=1) / 127.0, 1e-8)
    k_q = jnp.clip(jnp.round(flat / kscale[:, None]), -127, 127).astype(jnp.int8)
    k_sc, b_i8 = kscale / 254.0, fb + jnp.sum(flat, axis=1) * (127.0 / 254.0)
    cy, cx, inv = (jnp.asarray(a) for a in geometry)
    b, n = cy.shape[:2]
    views = fused_views_nchw(jnp.asarray(images).astype(jnp.bfloat16), cy, cx, inv, res,
                             interpret=True, quantize=True)
    x6 = views.reshape(b * n, 3, g, p, g, p).transpose(0, 2, 4, 1, 3, 5).reshape(b * n, g * g, -1)
    acc = jax.lax.dot_general(x6, k_q, (((2,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    tokens = acc.astype(jnp.float32) * k_sc + b_i8
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jp)
    feats = jclip.encode_image_tokens(pb, c, tokens, dtype=jnp.bfloat16, impl="fused", quant=jq,
                                      quant_folded=True)
    feats = l2_normalize(feats).reshape(b, n, -1).astype(jnp.float32)
    return np.asarray(solve_mta_batch(feats, jnp.asarray(text)))


@pytest.mark.parametrize("fuse", ["halves", "block"])
@pytest.mark.parametrize("mode", [None, "full"])
@pytest.mark.parametrize("width,prompts", [(192, 0), (128, 14)])
def test_engine_non_assembled_route_matches_jax(knobs, width, prompts, mode, fuse):
    """``TTAEngine(quant="int8")`` for an odd head count (3 heads, 50
    tokens) and a 64-token tower (14 visual prompts), dynamic and static
    "full" (calibrated on the same images as the JAX engine), under
    "halves" and "block", vs the JAX engine's route composed in interpret
    mode on the folded tree."""
    from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
    from jcf_tpu.ops.view_kernel import sample_view_centers

    knobs(fuse)
    cfg, res, src, n_random = _engine_cfg(width, prompts), 224, 240, 1
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(3, jclip.CLIPConfig(**cfg)))
    rng = np.random.default_rng(3)
    if prompts:
        jp["visual"]["vpt"] = (0.02 * rng.standard_normal((prompts, width))).astype(np.float32)
    images = rng.random((2, 3, src, src)).astype(np.float32)
    text = rng.standard_normal((10, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    geometry = [np.array(a) for a in sample_view_centers(jax.random.PRNGKey(3), 2, n_random + 1,
                                                         (src, src), res)]
    heads = {"visual": width // 64, "text": 1}
    if mode is None:
        jq = jquant.quantize_clip_params(jp, fold=True, heads=heads)["visual"]
    else:
        top = (src - res) // 2
        crops = (images[:, :, top:top + res, top:top + res]
                 - np.asarray(CLIP_MEAN, np.float32).reshape(1, 3, 1, 1)) \
            / np.asarray(CLIP_STD, np.float32).reshape(1, 3, 1, 1)
        amax = jclip.vision_ln_z_amax(jp, jclip.CLIPConfig(**cfg), jnp.asarray(crops))
        jq = jquant.quantize_clip_params(jp, fold=True, heads=heads, act_scales={"visual": amax},
                                         act_static=("ctx", "hidden"))["visual"]
    ref = _jax_tokens_modes(jp, cfg, images, geometry, text, jq)
    engine = TTAEngine(tclip.params_from_numpy(jp), tclip.CLIPConfig(**cfg), device="cpu",
                       quant="int8", n_views=n_random,
                       calibration_images=None if mode is None else images,
                       static_quant_mode=mode or "full")
    got = engine.features_from_images(torch.from_numpy(images).bfloat16(), torch.from_numpy(text),
                                      geometry=tuple(torch.from_numpy(a) for a in geometry))
    assert got.shape == (2, 32)
    assert mi._row_cos(got.numpy(), ref) >= 0.999


def test_engine_defaults_to_the_f32_unquantized_engine():
    """``TTAEngine(params, cfg)`` is the unquantized f32 engine, as the
    reference's default (``quant=None``): its features equal those of
    ``quant=None, dtype=torch.float32``."""
    cfg = tclip.CLIPConfig(**qm._cfg(224, layers=1))
    params = tclip.init_clip_params(0, cfg)
    default = TTAEngine(params, cfg, device="cpu", n_views=1)
    assert default.quant is None and default.dtype == torch.float32
    explicit = TTAEngine(params, cfg, device="cpu", n_views=1, quant=None, dtype=torch.float32)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((2, 3, 240, 240)).astype(np.float32))
    text = torch.nn.functional.normalize(torch.randn(5, 32, generator=torch.Generator()
                                                     .manual_seed(0)), dim=-1)
    geometry = default.sample_geometry(torch.Generator().manual_seed(1), 2, (240, 240))
    assert torch.equal(default.features_from_images(images, text, geometry=geometry),
                       explicit.features_from_images(images, text, geometry=geometry))
