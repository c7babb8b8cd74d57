"""Every quantization mode of the folded int8 tower below 128 tokens, and
the towers of 65 to 127 tokens, held against the JAX package on the CPU.

The modes are the JAX engine's (``jcf_tpu/infer/engine.py:351-420``):
dynamic per-row scales (no calibration), and with calibration the static
modes "ln", "hidden", "full", each with or without "+score". The JAX side
runs its Pallas kernels in interpret mode (``_halves_block``,
``_attn_cls_dense``, ``run_fused_tower(interpret=True)``) or their XLA
parts eagerly (``_quant_rows``, ``_paired_attention_nomask``,
``_mlp_half_cls_rows``); the port runs its plain versions.

Bars: trees equal (int8 bit for bit, f32 scales and shifts within 1 ulp);
the row quantization bit for bit; int8 intermediates off by at most 1 on
a stated share (f32 sums in another order land on the other side of a
rounding tie); a half's bf16 output within 1 bf16 ulp + 1e-3 on all but a
stated share of its elements (the ones an int8 tie moved), and everywhere
within 0.05 + 0.05 |ref| at row cos >= 0.999; towers and modes at row cos
>= 0.999."""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import quant as jquant
from jcf_tpu.ops.layers import l2_normalize
from jcf_tpu.tta import solve_mta_batch
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops import quant as tquant
from jcf_tpu_torch.ops import view_kernel as tvk
from jcf_tpu_torch.ops.layers import layer_slice

torch.set_num_threads(1)

H, E, CROPS = 2, 128, 4
MODES = [None, "ln", "hidden", "full", "ln+score", "full+score"]


def _cfg(res=224, layers=2, width=E):
    """Width 128 (2 heads of 64) at patch 32: 50 tokens at 224², 82 at 288²."""
    return dict(embed_dim=32, image_resolution=res, vision_layers=layers, vision_width=width,
                vision_patch_size=32, context_length=8, vocab_size=100, text_width=64,
                text_heads=1, text_layers=1)


def _jax_act_static(mode):
    """engine.py:371-403: the static quantizations a calibrated mode names."""
    base, _, suffix = mode.partition("+")
    act = {"ln": (), "hidden": ("hidden",), "full": ("ctx", "hidden")}[base]
    return act + (("score",) if suffix == "score" else ()), suffix == "score"


@functools.lru_cache(maxsize=None)
def _params(seed, res=224, layers=2):
    """JAX params (numpy leaves) with non-trivial LN affines and biases."""
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(seed, jclip.CLIPConfig(**_cfg(res, layers))))
    rng = np.random.default_rng(seed + 50)
    blocks = jp["visual"]["blocks"]
    for ln in ("ln_1", "ln_2"):
        blocks[ln]["scale"] = (1 + 0.1 * rng.standard_normal(blocks[ln]["scale"].shape)).astype(np.float32)
        blocks[ln]["bias"] = (0.1 * rng.standard_normal(blocks[ln]["bias"].shape)).astype(np.float32)
    for leaf in (blocks["attn"], blocks["mlp"]["c_fc"], blocks["mlp"]["c_proj"]):
        for k in [k for k in leaf if k.startswith("b")]:
            leaf[k] = (0.05 * rng.standard_normal(leaf[k].shape)).astype(np.float32)
    return jp


def _calib(seed, res):
    return np.random.default_rng(seed + 9).standard_normal((4, 3, res, res)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _trees(seed, mode, res=224, layers=2):
    """(JAX params, JAX folded tree, port folded tree) in ``mode``. Both
    take the JAX calibration's amax; for "+score" its score amax column is
    set to 43 + i so that layer i's shift is about 3 + i (random weights
    score far below the 40 the shift subtracts, which clamps it to 0)."""
    jp = _params(seed, res, layers)
    heads = {"visual": H, "text": 1}
    if mode is None:
        jq = jquant.quantize_clip_params(jp, fold=True, heads=heads)["visual"]
        tq = tquant.quantize_clip_params(tclip.params_from_numpy(jp), fold=True, heads=heads)["visual"]
        return jp, jq, tq
    act_static, with_scores = _jax_act_static(mode)
    amax = np.array(jclip.vision_ln_z_amax(jp, jclip.CLIPConfig(**_cfg(res, layers)),
                                           jnp.asarray(_calib(seed, res)), with_scores=with_scores))
    if with_scores:
        amax[:, 4] = 43.0 + np.arange(layers)
    jq = jquant.quantize_clip_params(jp, fold=True, heads=heads, act_scales={"visual": amax},
                                     act_static=act_static)["visual"]
    tq = tquant.quantize_clip_params(tclip.params_from_numpy(jp), fold=True, heads=heads,
                                     act_scales={"visual": torch.from_numpy(amax)},
                                     act_static=act_static)["visual"]
    return jp, jq, tq


def _rows(seed, s, crops=CROPS):
    x = np.random.default_rng(seed + 7).standard_normal((crops * s, E)).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def _jx(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _s_pad(s):
    return -(-s // 16) * 16


def _jax_layer(jp, jq, i):
    return (jax.tree_util.tree_map(lambda a: a[i], jp["visual"]["blocks"]),
            jax.tree_util.tree_map(lambda a: a[i], jq))


def _bias(s):
    return jnp.full((_s_pad(s), _s_pad(s)), jbk._NEG_INF, jnp.float32).at[:s, :s].set(0.0)


def _row_cos(got, ref):
    return ((got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1)
                                   + 1e-12)).min()


def _close_bf16(got, ref, share):
    """bf16 outputs: within 1 bf16 ulp + 1e-3 on all but ``share`` of the
    elements, everywhere within 0.05 + 0.05 |ref|, row cos >= 0.999."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    d = np.abs(got - ref)
    over = (d > 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3).mean()
    assert over <= share, over
    assert _row_cos(got, ref) >= 0.999
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def _close_int8(got, ref, share):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


# ---------------------------------------------------------------------------
# trees and calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_trees_match_jax(mode, seed):
    _, jq, tq = _trees(seed, mode)
    assert tq["quant_folded"] is True
    for half in ("attn", "mlp"):
        assert set(tq[half]) == set(jq[half]), half
        for name, r in jq[half].items():
            g = tq[half][name]
            if isinstance(r, jquant.QuantizedLinear):
                np.testing.assert_array_equal(g.w_int8.numpy(), np.asarray(r.w_int8), err_msg=name)
                np.testing.assert_array_max_ulp(g.w_scale.numpy(), np.asarray(r.w_scale), 1)
                # the folded biases sum W * ln_bias in another order
                np.testing.assert_allclose(g.bias.numpy(), np.asarray(r.bias), rtol=1e-5,
                                           atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_max_ulp(g.numpy(), np.asarray(r), 1)
    if mode is not None and mode.endswith("+score"):
        assert float(tq["attn"]["score_shift"].min()) > 2.0  # not clamped to 0


@pytest.mark.parametrize("res", [224, 288])
def test_vision_ln_z_amax_with_scores_matches_jax(res):
    jp = _params(2, res)
    cfg = _cfg(res)
    imgs = _calib(2, res)
    ref = np.asarray(jclip.vision_ln_z_amax(jp, jclip.CLIPConfig(**cfg), jnp.asarray(imgs),
                                            with_scores=True))
    got = tclip.vision_ln_z_amax(tclip.params_from_numpy(jp), tclip.CLIPConfig(**cfg),
                                 torch.from_numpy(imgs), with_scores=True)
    assert got.shape == ref.shape == (2, 6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_score_shift_clamps_like_jax():
    """The shift's three branches: the score amax less 40, the weakest row
    max + 80, and 0."""
    jp = _params(0)
    amax = np.tile(np.array([[4.0, 4.0, 2.0, 3.0, 0.0, 0.0]], np.float32), (2, 1))
    amax[:, 4], amax[:, 5] = [45.0, 200.0], [-3.0, 10.0]  # 5, then 10.5 + 80 < 200 - 40
    out = []
    for a in (amax, np.where(np.arange(6) == 4, 10.0, amax).astype(np.float32)):  # clamped to 0
        ref = jquant.quantize_clip_params(jp, fold=True, heads={"visual": H, "text": 1},
                                          act_scales={"visual": a}, act_static=("score",))
        got = tquant.quantize_clip_params(tclip.params_from_numpy(jp), fold=True, heads={"visual": H},
                                          act_scales={"visual": torch.from_numpy(a)},
                                          act_static=("score",))
        r, g = np.asarray(ref["visual"]["attn"]["score_shift"]), got["visual"]["attn"]["score_shift"]
        np.testing.assert_array_max_ulp(g.numpy(), r, 1)
        out.append(r.ravel())
    assert out[0][0] == pytest.approx(5.0, rel=1e-5) and out[0][1] == pytest.approx(90.5, rel=1e-5)
    assert (out[1] == 0.0).all()


# ---------------------------------------------------------------------------
# the row quantizations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_rows_bit_for_bit(seed):
    """``_quant_rows``: a reciprocal multiply, the 1e-8 floor on all-zero
    rows, the scale amax * f32(1/127)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 768)) * rng.uniform(1e-3, 30.0, (64, 1))).astype(np.float32)
    x[5] = 0.0
    x[9, ::2] = 0.0
    q_ref, s_ref = jbk._quant_rows(jnp.asarray(x))
    q, s = tbk.quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref)[:, 0])
    assert float(s[5]) == np.float32(1e-8) * np.float32(1.0 / 127.0) and not q[5].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_ln_and_gelu_row_quant_match_jax(seed):
    """LN z-norm + row quant (K3 / K4 heads, ``_quant_rows(_ln_norm(x))``)
    and QuickGELU + row quant over all hidden columns
    (``_quant_rows(_quick_gelu32(h))``): the statistics and tanh round in
    other places, so an int8 value may sit one step away on a tie."""
    x = _rows(seed, 50)
    q_ref, s_ref = jbk._quant_rows(jbk._ln_norm(_jx(x)))
    q, s = tbk.ln_quant_rows(x)
    _close_int8(q.numpy(), q_ref, 1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref)[:, 0], rtol=1e-6)
    h = np.random.default_rng(seed).standard_normal((200, 512)).astype(np.float32) * 3
    h[3] = 0.0
    q_ref, s_ref = jbk._quant_rows(jbk._quick_gelu32(jnp.asarray(h)))
    q, s = tbk.quant_rows(torch.from_numpy(h), gelu=True)
    _close_int8(q.numpy(), q_ref, 1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref)[:, 0], rtol=1e-6)


# ---------------------------------------------------------------------------
# attention, the halves and K5 in each mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [None, 1.5])
@pytest.mark.parametrize("static_ctx", [True, False])
@pytest.mark.parametrize("s", [50, 82])
def test_attention_matches_jax_paired(s, static_ctx, shift):
    """The attention section of K3 vs ``_paired_attention_nomask`` on the
    padded layout (pad keys zeroed: the shift is max(0, pair max), or the
    calibrated shift with no max): the int8 context with ``ctx_inv`` in
    the normalizer, or the f32 context then ``_quant_rows`` over the
    whole E-wide row."""
    rng = np.random.default_rng(s + 3 * static_ctx)
    qkv = torch.from_numpy(rng.standard_normal((CROPS * s, 3 * E)).astype(np.float32)).bfloat16()
    q3 = np.zeros((CROPS, _s_pad(s), 3 * E), np.float32)
    q3[:, :s] = qkv.float().numpy().reshape(CROPS, s, 3 * E)
    ref = jbk._paired_attention_nomask(
        jnp.asarray(q3).astype(jnp.bfloat16), H, E // H, None, CROPS, _s_pad(s), s_real=s,
        score_shift=None if shift is None else jnp.float32(shift),
        post_scale=jnp.float32(40.0) if static_ctx else None)
    ref = np.asarray(ref).reshape(CROPS, _s_pad(s), E)[:, :s].reshape(CROPS * s, E)
    got = tbk.attention(qkv, torch.tensor([[40.0]]) if static_ctx else None, s, H,
                        None if shift is None else torch.tensor([[shift]]))
    if static_ctx:
        assert got.dtype == torch.int8
        _close_int8(got.numpy(), np.clip(np.round(ref), -127, 127), 2e-2)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=2e-3)
        q_ref, s_ref = jbk._quant_rows(jnp.asarray(ref))
        q, sc = tbk.quant_rows(got)
        _close_int8(q.numpy(), q_ref, 2e-2)
        np.testing.assert_allclose(sc.numpy(), np.asarray(s_ref)[:, 0], rtol=1e-2)


@pytest.mark.parametrize("s", [50, 82])
@pytest.mark.parametrize("mode", MODES)
def test_halves_match_jax(mode, s):
    """K3 vs ``_halves_block(mlp_half=False)``; K4 vs
    ``_mlp_half_cls_rows`` (the same MLP-half math, XLA) on the same rows."""
    jp, jq, tq = _trees(0, mode)
    x = _rows(1, s)
    lp, lq = _jax_layer(jp, jq, 1)
    layer = layer_slice(tq, 1)
    ref = jbk._halves_block(_jx(x), lp, H, _bias(s), lq, True, mlp_half=False, s_real=s,
                            use_mask=False, quant_folded=True, dense=True, s_pad=_s_pad(s))
    mid = tbk.attn_half_int8(x, layer["attn"], s, H)
    assert mid.dtype == torch.bfloat16 and mid.shape == x.shape
    _close_bf16(mid.float().numpy(), _np(ref), 2e-2)
    ref = jbk._mlp_half_cls_rows(_jx(mid), lp, lq, quant_folded=True)
    _close_bf16(tbk.mlp_half_int8(mid, layer["mlp"]).float().numpy(), _np(ref), 2e-2)


@pytest.mark.parametrize("mode", MODES)
def test_attn_cls_matches_jax(mode):
    """K5 (CLS queries, the CLS rows' own scales where they are dynamic,
    the shift, f32-p normalizer) vs ``_attn_cls_dense`` in interpret mode."""
    jp, jq, tq = _trees(0, mode)
    x = _rows(2, 50, crops=8)
    lp, lq = _jax_layer(jp, jq, 1)
    ref = jbk._attn_cls_dense(_jx(x), lp, H, lq, True, s_real=50, quant_folded=True)
    got = tbk.attn_cls_int8(x, layer_slice(tq, 1)["attn"], 50, H)
    assert got.shape == (8, E)
    _close_bf16(got.float().numpy(), _np(ref), 2e-2)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls_only", [True, False])
@pytest.mark.parametrize("s", [50, 82])
@pytest.mark.parametrize("mode", MODES)
def test_tower_matches_jax(mode, s, cls_only):
    """``run_fused_tower`` in each mode, the CLS rows or every row, vs the
    JAX function in interpret mode: row cos >= 0.999 (int8 ties compound
    over layers)."""
    jp, jq, tq = _trees(0, mode)
    x = _rows(3, s)
    ref = jbk.run_fused_tower(_jx(x), jp["visual"]["blocks"], H, None, quant=jq, quant_folded=True,
                              interpret=True, flat_s=s, cls_only=cls_only)
    got = tbk.run_fused_tower(x, tq, H, flat_s=s, cls_only=cls_only)
    assert got.shape == ((CROPS, E) if cls_only else (CROPS * s, E)) and got.dtype == torch.bfloat16
    assert _row_cos(got.float().numpy(), _np(ref)) >= 0.999


@pytest.mark.parametrize("seed", [0, 1])
def test_cls_tower_at_82_tokens_takes_the_k3_route(seed):
    """ViT-B/32 at 288² (82 tokens), one layer, ``cls_only``: the last
    attention half is K3 on all rows, not K5, then K4 on the CLS rows, as
    the reference's ``_halves_block`` + ``_mlp_half_cls_rows`` past 64
    tokens; K5's f32-p normalizer would move the context's ties."""
    jp, jq, tq = _trees(seed, "full", res=288, layers=1)
    s = 82
    x = _rows(seed + 4, s, crops=6)
    lp, lq = _jax_layer(jp, jq, 0)
    mid = jbk._halves_block(_jx(x), lp, H, _bias(s), lq, True, mlp_half=False, s_real=s,
                            use_mask=False, quant_folded=True, dense=True, s_pad=_s_pad(s))
    ref = jbk._mlp_half_cls_rows(mid.reshape(-1, s, E)[:, 0], lp, lq, quant_folded=True)
    got = tbk.run_fused_tower(x, tq, H, flat_s=s)
    layer = layer_slice(tq, 0)
    route = tbk.mlp_half_int8(tbk.attn_half_int8(x, layer["attn"], s, H)[::s].contiguous(),
                              layer["mlp"])
    assert torch.equal(got, route)
    _close_bf16(got.float().numpy(), _np(ref), 2e-2)


# ---------------------------------------------------------------------------
# the engine: features_from_images in each mode, features_from_crops
# ---------------------------------------------------------------------------


def _jax_cloud(jp, cfg, crops, quant):
    """engine.py ``_encode_cloud``: the params cast to the compute dtype,
    ``encode_image`` (the fused route over a folded tree, in interpret
    mode), L2 norm -> [B, N, D] f32."""
    dtype = jnp.float32 if quant is None else jnp.bfloat16
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), jp)
    b, n = crops.shape[:2]
    feats = jclip.encode_image(params, jclip.CLIPConfig(**cfg), jnp.asarray(crops.reshape(b * n, *crops.shape[2:])),
                               dtype=dtype, impl=None if quant is None else "fused", quant=quant,
                               quant_folded=quant is not None)
    return l2_normalize(feats).reshape(b, n, -1).astype(jnp.float32)


@pytest.mark.parametrize("quant", ["int8", None])
def test_features_from_crops_matches_jax(quant):
    """The dynamic int8 engine (no calibration) and the f32 engine: crop
    features and MTA modes vs the JAX composition at cos >= 0.999, and
    ``features_from_crops == mta_from_features(crop_features)``."""
    cfg = _cfg(224)
    jp = _params(3)
    rng = np.random.default_rng(3)
    crops = rng.standard_normal((2, 5, 3, 224, 224)).astype(np.float32)
    text = rng.standard_normal((10, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    jq = None
    if quant is not None:
        jq = jquant.quantize_clip_params(jp, fold=True, heads={"visual": H, "text": 1})["visual"]
    feats_ref = _jax_cloud(jp, cfg, crops, jq)
    modes_ref = np.asarray(solve_mta_batch(feats_ref, jnp.asarray(text)))
    engine = TTAEngine(tclip.params_from_numpy(jp), tclip.CLIPConfig(**cfg), device="cpu",
                       quant=quant)
    feats = engine.crop_features(torch.from_numpy(crops))
    assert feats.shape == (2, 5, 32) and feats.dtype == torch.float32
    assert _row_cos(feats.numpy().reshape(10, -1), np.asarray(feats_ref).reshape(10, -1)) >= 0.999
    modes = engine.features_from_crops(torch.from_numpy(crops), torch.from_numpy(text))
    assert torch.equal(modes, engine.mta_from_features(feats, torch.from_numpy(text)))
    assert _row_cos(modes.numpy(), modes_ref) >= 0.999


def _jax_images(jp, cfg, images, geometry, text, jq):
    """engine.py features_from_images_spec -> _rows_feats, composed from
    the JAX functions (as ``tests/test_torch_slice.py``), any folded tree."""
    from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
    from jcf_tpu.ops.assemble_kernel import assemble_dense_rows, make_cls_row
    from jcf_tpu.ops.view_kernel import fused_views_nchw

    c = jclip.CLIPConfig(**cfg)
    res, p, g = c.image_resolution, c.vision_patch_size, c.grid_size
    w4f, fb = jclip.fold_normalize_into_embed(jp["visual"]["patch_embed"]["w"], CLIP_MEAN, CLIP_STD, p)
    flat = jnp.transpose(w4f, (3, 0, 1, 2)).reshape(w4f.shape[3], -1)  # engine.py:470-480
    kscale = jnp.maximum(jnp.max(jnp.abs(flat), axis=1) / 127.0, 1e-8)
    k_q = jnp.clip(jnp.round(flat / kscale[:, None]), -127, 127).astype(jnp.int8)
    k_sc, b_i8 = kscale / 254.0, fb + jnp.sum(flat, axis=1) * (127.0 / 254.0)
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jp)["visual"]
    cy, cx, inv = (jnp.asarray(a) for a in geometry)
    b, n = cy.shape[:2]
    views = fused_views_nchw(jnp.asarray(images).astype(jnp.bfloat16), cy, cx, inv, res,
                             interpret=True, quantize=True)
    x6 = views.reshape(b * n, 3, g, p, g, p).transpose(0, 2, 4, 1, 3, 5).reshape(b * n, g * g, -1)
    acc = jax.lax.dot_general(x6, k_q, (((2,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    lnp = v["ln_pre"]
    cls_row = make_cls_row(v["class_embedding"], v["positional_embedding"][0], lnp["scale"],
                           lnp["bias"], dtype=jnp.bfloat16)
    rows = assemble_dense_rows(acc.reshape(b * n, g, g, -1), k_sc, b_i8, v["positional_embedding"][1:],
                               cls_row, lnp["scale"], lnp["bias"], dtype=jnp.bfloat16, interpret=True)
    feats = jclip.encode_image_rows_dense({"visual": v}, c, rows, dtype=jnp.bfloat16, quant=jq,
                                          quant_folded=True)
    feats = l2_normalize(feats).reshape(b, n, -1).astype(jnp.float32)
    return np.asarray(solve_mta_batch(feats, jnp.asarray(text)))


@pytest.mark.parametrize("res,mode", [(224, m) for m in MODES] + [(288, "full"), (288, None)])
def test_engine_modes_match_jax(res, mode):
    """``TTAEngine(quant="int8")`` built in each mode (calibrated on the
    same images as the JAX engine: their center crops, CLIP-normalized)
    serves ``features_from_images`` as the JAX composition does; at 288²
    the last layer takes K3 + K4."""
    from jcf_tpu.data.transforms import CLIP_MEAN, CLIP_STD
    from jcf_tpu.ops.view_kernel import sample_view_centers

    cfg, src, n_random = _cfg(res), res + 16, 2
    jp = _params(4, res)
    rng = np.random.default_rng(4)
    images = rng.random((2, 3, src, src)).astype(np.float32)
    text = rng.standard_normal((10, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    geometry = [np.array(a) for a in sample_view_centers(jax.random.PRNGKey(4), 2, n_random + 1,
                                                         (src, src), res)]
    heads = {"visual": H, "text": 1}
    if mode is None:
        jq = jquant.quantize_clip_params(jp, fold=True, heads=heads)["visual"]
    else:
        act_static, with_scores = _jax_act_static(mode)
        top = (src - res) // 2
        crops = (images[:, :, top:top + res, top:top + res]
                 - np.asarray(CLIP_MEAN, np.float32).reshape(1, 3, 1, 1)) \
            / np.asarray(CLIP_STD, np.float32).reshape(1, 3, 1, 1)
        amax = jclip.vision_ln_z_amax(jp, jclip.CLIPConfig(**cfg), jnp.asarray(crops),
                                      with_scores=with_scores)
        jq = jquant.quantize_clip_params(jp, fold=True, heads=heads, act_scales={"visual": amax},
                                         act_static=act_static)["visual"]
    ref = _jax_images(jp, cfg, images, geometry, text, jq)
    engine = TTAEngine(tclip.params_from_numpy(jp), tclip.CLIPConfig(**cfg), device="cpu",
                       n_views=n_random, calibration_images=None if mode is None else images,
                       static_quant_mode=mode or "full")
    got = engine.features_from_images(torch.from_numpy(images).bfloat16(), torch.from_numpy(text),
                                      geometry=tuple(torch.from_numpy(a) for a in geometry))
    assert got.shape == (2, 32)
    assert _row_cos(got.numpy(), ref) >= 0.999


# ---------------------------------------------------------------------------
# options and refusals
# ---------------------------------------------------------------------------


def test_crop_scale_reaches_the_sampler():
    """``crop_scale`` (default (0.5, 1.0)) sets the random views' area share."""
    params = tclip.init_clip_params(0, tclip.CLIPConfig(**_cfg(224, layers=1)))
    cfg = tclip.CLIPConfig(**_cfg(224, layers=1))
    assert TTAEngine(params, cfg, device="cpu", quant=None).crop_scale == tvk.CROP_SCALE == (0.5, 1.0)
    engine = TTAEngine(params, cfg, device="cpu", quant=None, n_views=64, crop_scale=(0.2, 0.2))
    geo = engine.sample_geometry(torch.Generator().manual_seed(0), 3, (512, 512))
    ref = tvk.sample_view_centers(torch.Generator().manual_seed(0), 3, 65, (512, 512), 224,
                                  scale=(0.2, 0.2))
    assert all(torch.equal(a, b) for a, b in zip(geo, ref))
    boxes, _ = tvk.sample_tta_boxes(torch.Generator().manual_seed(0), 3, 64, (512, 512), 224,
                                    scale=(0.2, 0.2))
    area = boxes[:, 1:, 2] * boxes[:, 1:, 3]
    np.testing.assert_allclose(area.numpy(), 0.2 * 512 * 512, rtol=1e-4)


def test_refusals(monkeypatch):
    """What stays refused: unknown static modes; the engine's odd-head and
    64-token towers (its non-assembled route is not ported); an unfolded
    tree without the blocks that hold its LN affine; the ``_FUSE`` routes
    that need K9a/c/d off the serving flags (the 64-token and the
    unfolded towers themselves run under "halves",
    ``tests/test_torch_masked_int8.py``)."""
    cfg = _cfg(224, layers=1)
    params = tclip.init_clip_params(0, tclip.CLIPConfig(**cfg))
    imgs = np.random.default_rng(0).random((2, 3, 224, 224)).astype(np.float32)
    for mode in ("medium", "full+shift", "ln+score+score"):
        with pytest.raises(ValueError, match="static_quant_mode"):
            TTAEngine(params, tclip.CLIPConfig(**cfg), device="cpu", calibration_images=imgs,
                      static_quant_mode=mode)
    odd = _cfg(224, layers=1, width=192)  # 3 heads
    with pytest.raises(ValueError, match="use_mask"):
        TTAEngine(tclip.init_clip_params(0, tclip.CLIPConfig(**odd)), tclip.CLIPConfig(**odd),
                  device="cpu")
    s64 = dict(cfg, vision_prompt_tokens=14)  # 49 patches + CLS + 14 prompts
    with pytest.raises(ValueError, match="multiple of 16"):
        TTAEngine(tclip.init_clip_params(0, tclip.CLIPConfig(**s64)), tclip.CLIPConfig(**s64),
                  device="cpu")
    tree = tquant.quantize_clip_params(params, fold=True, heads={"visual": H})["visual"]
    monkeypatch.setattr(tbk, "_FUSE", "block")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tbk.run_fused_tower(_rows(0, 64), tree, H, flat_s=64)
    unfolded = tquant.quantize_clip_params(params)["visual"]
    monkeypatch.setattr(tbk, "_FUSE", "layer")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tbk.run_fused_tower(_rows(0, 50), unfolded, H, flat_s=50,
                            blocks=params["visual"]["blocks"])
    monkeypatch.setattr(tbk, "_FUSE", "halves")
    with pytest.raises(ValueError, match="blocks"):
        tbk.run_fused_tower(_rows(0, 50), unfolded, H, flat_s=50)


@pytest.mark.parametrize("fuse", ["block", "layer", "stream"])
@pytest.mark.parametrize("mode", [None, "ln", "hidden+score"])
def test_whole_layer_routes_refuse_other_modes(monkeypatch, fuse, mode):
    """The whole-layer routes (K9a, K9d, K9c) took only the serving flags
    and refused these modes; they now take every folded mode. The tower
    under ``_FUSE`` = ``fuse`` in ``mode`` against the JAX function in
    interpret mode under the same ``_FUSE``: row cos >= 0.999, as the
    halves' towers above."""
    jp, jq, tq = _trees(0, mode)
    x = _rows(0, 50)
    for mod in (jbk, tbk):
        monkeypatch.setattr(mod, "_FUSE", fuse)
    ref = jbk.run_fused_tower(_jx(x), jp["visual"]["blocks"], H, None, quant=jq, quant_folded=True,
                              interpret=True, flat_s=50, cls_only=True)
    got = tbk.run_fused_tower(x, tq, H, flat_s=50)
    assert got.shape == (CROPS, E) and got.dtype == torch.bfloat16
    assert _row_cos(got.float().numpy(), _np(ref)) >= 0.999
