"""The masked and unfolded int8 halves of the port (K3 / K4 / K5 with
``use_mask=True`` and ``folded=False``): the LN-affine row quantization
(kernel A), the masked attention (kernel B), the f32-residual GEMM
epilogues (kernel C, by their plain versions), one layer and whole towers
on each route the JAX package takes on its chip (the unfolded dense
vision tower, the causal text tower in f32 and bf16, folded and
unfolded, odd head counts, a 64-token tower), ``encode_text(quant=)``
and the int8 classifier build, the text trees, and the repairs (the
unfolded tree below 128 tokens takes the fused tower; the text entry
points and ``quantize_clip_params`` default as the JAX package's).

The port runs its plain versions on the CPU; the JAX side runs its Pallas
kernels in interpret mode (``_halves_block``, ``run_fused_tower``) or
their XLA parts eagerly (``_ln_rows``, ``_quant_rows``,
``_batched_attention``), on the same seeded numpy inputs, at width 128
with 2 heads of 64 (1 and 3 heads for the odd-head routes).

Bars: the row quantization bit for bit away from rounding ties (the f32
statistics sum in another order); the attention's f32 context within
1e-5 + 1e-5 |ref| + 2^-7 sum_j p_j |v_j| (a p that rounds to bf16 across
a tie), its int8 context off by at most 1 on 2% of the elements; a bf16
half within 1 bf16 ulp + 1e-3 on all but a stated share of its elements
(the ones an int8 tie moved) and everywhere within 0.05 + 0.05 |ref| at
row cos >= 0.999; an f32 half within 0.05 + 0.05 |ref| at row cos >=
0.999 (f32 LN sums are inexact, so int8 ties flip); towers, text
features and classifiers at row cos >= 0.999."""

import functools
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import quant as jquant
from jcf_tpu.ops.attention import causal_mask
from jcf_tpu.tta import build_classifier_weights as j_build
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import attention as tattn
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops import int8_gemm as tig
from jcf_tpu_torch.ops import layers as tlayers
from jcf_tpu_torch.ops import quant as tquant
from jcf_tpu_torch.ops.layers import layer_slice
from jcf_tpu_torch.tta import classifier as tcls

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, H = 128, 2  # width and heads of the even-head towers: head dim 64
CROPS = 3


def _cfg(width=E, res=64, patch=16, vocab=1000):
    """A small CLIP: the vision tower at ``width`` (heads of 64; S = 17 at
    64² / 16, 50 at 224² / 32), the text tower at width 128, 2 heads, 77
    tokens; 2 layers each. The classifier's tokenizer needs the real
    49408-entry vocab."""
    return dict(embed_dim=32, image_resolution=res, vision_layers=2, vision_width=width,
                vision_patch_size=patch, context_length=77, vocab_size=vocab, text_width=E,
                text_heads=H, text_layers=2)


@functools.lru_cache(maxsize=None)
def _params(seed, width=E, res=64, patch=16, vocab=1000):
    """JAX params (numpy leaves) with nonzero LN affines and biases in both
    towers, so every term of the unfolded halves is exercised."""
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(
        seed, jclip.CLIPConfig(**_cfg(width, res, patch, vocab))))
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


def _tower(jp, tower, folded, n_heads):
    """(JAX stacked blocks, JAX tree, port blocks, port tree) of one tower."""
    heads = {"visual": n_heads, "text": n_heads}
    jq = jquant.quantize_clip_params(jp, fold=folded, heads=heads if folded else None)[tower]
    tp = tclip.params_from_numpy(jp)
    tq = tquant.quantize_clip_params(tp, fold=folded, heads=heads if folded else None)[tower]
    return jp[tower]["blocks"], jq, tp[tower]["blocks"], tq


def _rows(seed, n, width=E, dtype=torch.bfloat16):
    x = np.random.default_rng(seed + 7).standard_normal((n, width)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _jx(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                 else jnp.float32)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _row_cos(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return ((got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1)
                                   + 1e-12)).min()


def _close_bf16(got, ref, share):
    """bf16: within 1 bf16 ulp + 1e-3 on all but ``share`` of the elements,
    everywhere within 0.05 + 0.05 |ref|, row cos >= 0.999."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    d = np.abs(got - ref)
    over = (d > 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3).mean()
    assert over <= share, over
    _close_f32(got, ref)


def _close_f32(got, ref):
    """Within 0.05 + 0.05 |ref| everywhere, row cos >= 0.999."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert _row_cos(got, ref) >= 0.999, _row_cos(got, ref)
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def _close_int8(got, ref, share):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


def _pad8(s):
    return -(-s // 8) * 8


def _bias(s, s_pad, causal):
    """The reference's additive [S_pad, S_pad] bias: -1e30 on pad keys, the
    causal mask or 0 on real ones (run_fused_tower)."""
    block = causal_mask(s) if causal else jnp.zeros((s, s), jnp.float32)
    return jnp.full((s_pad, s_pad), jbk._NEG_INF, jnp.float32).at[:s, :s].set(block)


def _padded(x, s, s_pad):
    """Flat rows [B * S, E] -> the reference's padded [B, S_pad, E]."""
    b = x.shape[0] // s
    return jnp.pad(_jx(x).reshape(b, s, -1), ((0, 0), (0, s_pad - s), (0, 0)))


def _unpad(a, s):
    a = _np(a)
    return a[:, :s].reshape(-1, a.shape[-1])


# ---------------------------------------------------------------------------
# kernel A: LN with its affine, then dynamic per-row int8
# ---------------------------------------------------------------------------


@settings(max_examples=8, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10**6), rows=st.integers(1, 40),
       width=st.sampled_from([64, 128, 192]), f32=st.booleans())
def test_ln_affine_quant_rows_matches_jax(seed, rows, width, f32):
    """``ln_affine_quant_rows_plain`` vs ``_quant_rows(_ln_rows(x, g, b))``
    with the affine in x's dtype: int8 equal wherever the reference's
    ``y * 127 / amax`` lies more than 1e-3 from a rounding tie, within 1
    elsewhere; the row scales to f32 rounding."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, width)) * rng.uniform(0.05, 20.0, (rows, 1))).astype(np.float32)
    x[0, ::3] = 0.0
    g = (1 + 0.2 * rng.standard_normal(width)).astype(np.float32)
    b = (0.2 * rng.standard_normal(width)).astype(np.float32)
    dt = jnp.float32 if f32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(dt)
    y = jbk._ln_rows(xj, jnp.asarray(g).astype(dt), jnp.asarray(b).astype(dt))
    q_ref, s_ref = jbk._quant_rows(y)
    t = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32)))
    q, s = tbk.ln_affine_quant_rows(t(xj).to(torch.float32 if f32 else torch.bfloat16),
                                    t(jnp.asarray(g).astype(dt)), t(jnp.asarray(b).astype(dt)))
    scaled = np.asarray(y) * (127.0 / np.maximum(np.abs(np.asarray(y)).max(-1, keepdims=True), 1e-8))
    away = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5) > 1e-3
    q, q_ref = q.numpy().astype(np.int32), np.asarray(q_ref).astype(np.int32)
    np.testing.assert_array_equal(q[away], q_ref[away])
    assert np.abs(q - q_ref).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref)[:, 0], rtol=1e-6)


# ---------------------------------------------------------------------------
# kernel B: the masked attention
# ---------------------------------------------------------------------------


def _jax_masked(qkv, s, n_heads, *, causal, scale, post_scale=None):
    """``_batched_attention(use_mask=True)`` on the reference's padded
    layout -> the f32 context of the real rows [B * S, E] (x post_scale)."""
    e = qkv.shape[1] // 3
    b, s_pad = qkv.shape[0] // s, _pad8(s)
    q3 = _padded(qkv, s, s_pad).reshape(b * s_pad, 3 * e)
    out = jbk._batched_attention(q3, _bias(s, s_pad, causal), n_heads, e // n_heads, scale, b,
                                 s_pad, s_real=s, use_mask=True,
                                 post_scale=None if post_scale is None else jnp.float32(post_scale))
    return _unpad(out.reshape(b, s_pad, e), s)


MASKED = [(16, 2, True), (17, 2, True), (77, 2, True), (17, 1, False), (50, 3, False)]


@pytest.mark.parametrize("s,n_heads,causal", MASKED)
@pytest.mark.parametrize("folded", [True, False])
def test_masked_attention_matches_jax(s, n_heads, causal, folded):
    """The int8 halves' masked attention on bf16 qkv: the f32 context (a
    dynamic context scale) and the int8 context (a static one,
    post-multiplied), with the scores x 1/sqrt(d) (unfolded) or not (the
    folded q carries it)."""
    rng = np.random.default_rng(s + 10 * n_heads)
    e = 64 * n_heads
    qkv = torch.from_numpy(rng.standard_normal((CROPS * s, 3 * e)).astype(np.float32) * 1.5).bfloat16()
    scale = None if folded else 1.0 / 8.0
    ref = _jax_masked(qkv, s, n_heads, causal=causal, scale=scale)
    got = tbk.masked_attention(qkv, s, n_heads, causal=causal, scale=scale, f32_ctx=True)
    assert got.dtype == torch.float32 and got.shape == (CROPS * s, e)
    v_abs = torch.cat([qkv[:, : 2 * e], qkv[:, 2 * e :].abs()], 1)
    slack = 2.0**-7 * tbk.masked_attention(v_abs, s, n_heads, causal=causal, scale=scale,
                                           f32_ctx=True).numpy()
    assert (np.abs(got.numpy() - ref) <= 1e-5 + 1e-5 * np.abs(ref) + slack).all()
    ref8 = np.clip(np.round(_jax_masked(qkv, s, n_heads, causal=causal, scale=scale,
                                        post_scale=40.0)), -127, 127)
    got8 = tbk.masked_attention(qkv, s, n_heads, causal=causal, scale=scale,
                                ctx_inv=torch.tensor([[40.0]]))
    assert got8.dtype == torch.int8
    _close_int8(got8.numpy(), ref8, 2e-2)


@pytest.mark.parametrize("s,n_heads,causal", [(77, 2, True), (17, 1, False), (50, 3, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_attention_float_halves(s, n_heads, causal, dtype):
    """The float halves' masked attention (K6a ``use_mask=True``: the
    causal text tower, odd heads without a mask): the context in qkv's
    dtype, the scores x 1/sqrt(d)."""
    rng = np.random.default_rng(s + n_heads)
    e = 64 * n_heads
    qkv = torch.from_numpy(rng.standard_normal((CROPS * s, 3 * e)).astype(np.float32)).to(dtype)
    ref = _jax_masked(qkv, s, n_heads, causal=causal, scale=1.0 / 8.0)
    got = tbk.masked_attention(qkv, s, n_heads, causal=causal, scale=1.0 / 8.0)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        _close_bf16(got.float().numpy(), ref.astype(jnp.bfloat16).astype(np.float32), 2e-2)


# ---------------------------------------------------------------------------
# kernel C and K3's mask-free attention with the unfolded scale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows_scaled", [False, True])
def test_f32_residual_epilogue(rows_scaled):
    """The f32 residual epilogue: ``f32(resid + ((acc * scale) [*
    row_scale] + bias))`` in that order, as ``_attn_half_int8_kernel``
    adds the f32 projection to an f32 residual."""
    rng = np.random.default_rng(3 + rows_scaled)
    a = torch.from_numpy(rng.integers(-127, 128, (9, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 64)).astype(np.int8))
    ws, bias = torch.rand(16) * 1e-3, torch.randn(16)
    rs = torch.rand(9) * 0.03 if rows_scaled else None
    resid = torch.randn(9, 16)
    acc = tig.int8_matmul_plain(a, w).float() * ws
    ref = resid + ((acc * rs[:, None] if rows_scaled else acc) + bias)
    got = tig.int8_gemm_residual(a, w, ws, bias, resid, row_scale=rs)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("s,dense", [(50, True), (56, True), (64, False)])
def test_unfolded_pair_attention_matches_jax(s, dense):
    """K3's mask-free attention with the scores x 1/sqrt(d) (the unfolded
    tree) vs ``_paired_attention_nomask``: on the dense route (S not a
    multiple of 16) the zeroed pad keys floor the pair shift at 0; on the
    non-dense route (S = 64 = s_pad) there is no floor."""
    rng = np.random.default_rng(s)
    qkv = torch.from_numpy(rng.standard_normal((CROPS * s, 3 * E)).astype(np.float32) * 2).bfloat16()
    s_pad = -(-s // 16) * 16 if dense else _pad8(s)
    q3 = _padded(qkv, s, s_pad)
    ref = jbk._paired_attention_nomask(q3, H, E // H, 1.0 / 8.0, CROPS, s_pad, s_real=s)
    ref = _unpad(ref.reshape(CROPS, s_pad, E), s)
    got = tbk.attention(qkv, None, s, H, scale=1.0 / 8.0, floor=0.0 if dense else -np.inf)
    v_abs = torch.cat([qkv[:, : 2 * E], qkv[:, 2 * E :].abs()], 1)
    slack = 2.0**-7 * tbk.attention(v_abs, None, s, H, scale=1.0 / 8.0,
                                    floor=0.0 if dense else -np.inf).numpy()
    assert (np.abs(got.numpy() - ref) <= 1e-5 + 1e-5 * np.abs(ref) + slack).all()


# ---------------------------------------------------------------------------
# one layer of the halves on each route
# ---------------------------------------------------------------------------

# (name, tower, folded, heads, S, causal, rows dtype): the routes of the
# JAX package's run_fused_tower that this slice ports
ROUTES = {
    "unfolded dense": ("visual", False, 2, 17, False, torch.bfloat16),
    "unfolded causal f32": ("text", False, 2, 77, True, torch.float32),
    "unfolded causal bf16": ("text", False, 2, 77, True, torch.bfloat16),
    "folded causal": ("text", True, 2, 77, True, torch.bfloat16),
    "odd heads": ("visual", False, 3, 17, False, torch.bfloat16),
    "S = 64 non-dense": ("visual", False, 2, 64, False, torch.bfloat16),
}


def _route(name, seed=0):
    tower, folded, n_heads, s, causal, dtype = ROUTES[name]
    jp = _params(seed, 64 * n_heads)
    jb, jq, tb, tq = _tower(jp, tower, folded, n_heads)
    e = 64 * n_heads if tower == "visual" else E
    return jb, jq, tb, tq, n_heads, s, causal, dtype, e


@pytest.mark.parametrize("name", list(ROUTES))
def test_halves_match_jax(name):
    """K3, then K4 on the same mid rows, vs ``_halves_block`` on the
    reference's layout for the route (dense flat rows, or the padded
    [B, S_pad, E] with its additive bias)."""
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = _route(name)
    folded = tq["quant_folded"]
    x = _rows(1, CROPS * s, e, dtype)
    i = 1
    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]), jb)
    lq = jax.tree_util.tree_map(lambda a: a[i], jq)
    layer = layer_slice(tq, i)
    use_mask = causal or n_heads % 2 == 1
    dense = not use_mask and s % 16 != 0
    s_pad = -(-s // 16) * 16 if dense else _pad8(s)
    kw = dict(s_real=s, use_mask=use_mask, quant_folded=folded, dense=dense, s_pad=s_pad)
    xj = _jx(x) if dense else _padded(x, s, s_pad)
    bias = _bias(s, s_pad, causal)
    mid_ref = jbk._halves_block(xj, lp, n_heads, bias, lq, True, mlp_half=False, **kw)
    out_ref = jbk._halves_block(xj, lp, n_heads, bias, lq, True, **kw)
    unpad = (lambda a: _np(a)) if dense else (lambda a: _unpad(a, s))
    lns = [None, None] if folded else [tbk._layer_ln(tb, i, n, dtype) for n in ("ln_1", "ln_2")]
    mid = tbk.attn_half_int8(x, layer["attn"], s, n_heads, ln=lns[0], causal=causal, dense=dense)
    assert mid.dtype == dtype and mid.shape == x.shape
    mid_j = torch.from_numpy(unpad(mid_ref)).to(dtype)
    out = tbk.mlp_half_int8(mid_j, layer["mlp"], ln=lns[1])
    for got, ref in ((mid, unpad(mid_ref)), (out, unpad(out_ref))):
        if dtype == torch.float32:
            _close_f32(got.numpy(), ref)
        else:
            _close_bf16(got.float().numpy(), ref, 2e-2)


def test_attn_cls_unfolded_matches_jax():
    """K5 on the unfolded tree (LN affine in bf16, scores x 1/sqrt(d)) vs
    ``_attn_cls_dense(quant_folded=False)``, and the CLS rows' MLP half
    with the layer params' f32 LN affine vs ``_mlp_half_cls_rows``."""
    jp = _params(2, E, 224, 32)
    jb, jq, tb, tq = _tower(jp, "visual", False, H)
    s = 50
    x = _rows(2, 8 * s)
    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]), jb)
    lq = jax.tree_util.tree_map(lambda a: a[1], jq)
    layer = layer_slice(tq, 1)
    ref = jbk._attn_cls_dense(_jx(x), lp, H, lq, True, s_real=s, quant_folded=False)
    got = tbk.attn_cls_int8(x, layer["attn"], s, H, ln=tbk._layer_ln(tb, 1, "ln_1", torch.bfloat16))
    assert got.shape == (8, E)
    _close_bf16(got.float().numpy(), _np(ref), 2e-2)
    mid = torch.from_numpy(_np(ref)).bfloat16()
    ref = jbk._mlp_half_cls_rows(_jx(mid), lp, lq, quant_folded=False)
    got = tbk.mlp_half_int8(mid, layer["mlp"], ln=tbk._layer_ln(tb, 1, "ln_2", None))
    _close_bf16(got.float().numpy(), _np(ref), 2e-2)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls_only", [True, False])
@pytest.mark.parametrize("name", list(ROUTES))
def test_tower_matches_jax(name, cls_only):
    """``run_fused_tower`` (2 layers) vs the JAX function in interpret mode
    with the same tree, mask and ``cls_only``: row cos >= 0.999 (int8 ties
    compound over layers)."""
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = _route(name)
    x = _rows(3, CROPS * s, e, dtype)
    folded = tq["quant_folded"]
    ref = jbk.run_fused_tower(_jx(x), jax.tree_util.tree_map(jnp.asarray, jb), n_heads,
                              causal_mask(s) if causal else None, quant=jq, quant_folded=folded,
                              interpret=True, flat_s=s, cls_only=cls_only)
    got = tbk.run_fused_tower(x, tq, n_heads, flat_s=s, cls_only=cls_only, blocks=tb,
                              causal=causal)
    assert got.dtype == dtype and got.shape == ((CROPS, e) if cls_only else (CROPS * s, e))
    assert _row_cos(got.float().numpy(), _np(ref).reshape(got.shape)) >= 0.999


@pytest.mark.parametrize("fuse", ["layer", "stream"])
def test_non_dense_routes_run_the_halves_under_fuse(monkeypatch, fuse):
    """Under ``_FUSE`` = "layer" and "stream" the non-dense routes run the
    halves, as the JAX package falls back (``fused_block``); under "block"
    they run K9a per layer: exactly the composition of ``block_int8`` on
    the route, close to the halves (its mid stays f32 where the halves
    round it to the rows' dtype)."""
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = _route("unfolded causal bf16")
    x = _rows(4, CROPS * s, e, dtype)
    halves = tbk.run_fused_tower(x, tq, n_heads, flat_s=s, cls_only=False, blocks=tb, causal=True)
    monkeypatch.setattr(tbk, "_FUSE", fuse)
    got = tbk.run_fused_tower(x, tq, n_heads, flat_s=s, cls_only=False, blocks=tb, causal=True)
    assert torch.equal(got, halves)
    monkeypatch.setattr(tbk, "_FUSE", "block")
    got = tbk.run_fused_tower(x, tq, n_heads, flat_s=s, cls_only=False, blocks=tb, causal=True)
    by_layer = x
    for i in range(2):
        lns = tuple(tbk._layer_ln(tb, i, n, dtype) for n in ("ln_1", "ln_2"))
        by_layer = tbk.block_int8(by_layer, layer_slice(tq, i), s, n_heads, lns=lns, causal=True,
                                  dense=False)
    assert torch.equal(got, by_layer)
    assert _row_cos(got.float().numpy(), halves.float().numpy()) >= 0.999


def test_quant_flags_read_the_routes():
    _, _, _, tq = _tower(_params(0), "text", False, H)
    flags = tbk.quant_flags(tq, dense=False, use_mask=True)
    assert flags & tbk.FLAG_USE_MASK and not flags & (tbk.FLAG_DENSE | tbk.FLAG_FOLDED)
    assert tbk.quant_flags(tq) == tbk.FLAG_DENSE


# ---------------------------------------------------------------------------
# the int8 text tower, the classifier, the text trees
# ---------------------------------------------------------------------------


def _ids(seed, b=4):
    """Token ids shaped like tokenized prompts: SOT, words, EOT (the max
    id), zero padding."""
    rng = np.random.default_rng(seed + 7)
    ids = np.zeros((b, 77), np.int32)
    for i in range(b):
        n = int(rng.integers(3, 20))
        ids[i, 0] = 998
        ids[i, 1 : n + 1] = rng.integers(1, 998, n)
        ids[i, n + 1] = 999
    return ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_text_int8_matches_jax(dtype):
    """``encode_text(quant=quantize_clip_params(params)["text"])`` vs the
    JAX function's fused route (``impl="fused"``: ``run_fused_tower`` with
    the causal mask and the unfolded tree, interpret mode)."""
    jp = _params(5)
    ids = _ids(5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq = jquant.quantize_clip_params(jp)["text"]
    ref = _np(jclip.encode_text(jp, jclip.CLIPConfig(**_cfg()), jnp.asarray(ids), dtype=jdt,
                                impl="fused", quant=jq))
    tp = tclip.params_from_numpy(jp)
    got = tclip.encode_text(tp, tclip.CLIPConfig(**_cfg()), ids, device="cpu", dtype=dtype,
                            quant=tquant.quantize_clip_params(tp)["text"])
    assert got.dtype == dtype and got.shape == (4, 32)
    assert _row_cos(got.float().numpy(), ref) >= 0.999


NAMES = ["cat", "dog", "red car", "tree", "boat"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_classifier_matches_jax(dtype):
    """``build_classifier_weights(quant=)`` vs the JAX package's, and the
    certificate of ``tests/test_quant.py``: its rows against the f32
    classifier's at cos > 0.99."""
    jp = _params(6, vocab=49408)
    templates = {i: [f"a photo of a {n}.", f"a {n}.", f"art of the {n}."] for i, n in enumerate(NAMES)}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq = jquant.quantize_clip_params(jp)["text"]
    ref = _np(j_build(jax.tree_util.tree_map(jnp.asarray, jp), jclip.CLIPConfig(**_cfg(vocab=49408)),
                      templates, dtype=jdt, impl="fused", quant=jq))
    tp = tclip.params_from_numpy(jp)
    cfg = tclip.CLIPConfig(**_cfg(vocab=49408))
    got = tcls.build_classifier_weights(tp, cfg, templates, device="cpu", dtype=dtype,
                                        quant=tquant.quantize_clip_params(tp)["text"])
    assert got.dtype == dtype and got.shape == (len(NAMES), 32)
    assert _row_cos(got.float().numpy(), ref) >= 0.999
    f32 = tcls.build_classifier_weights(tp, cfg, templates, device="cpu")
    assert _row_cos(got.float().numpy(), f32.numpy()) > 0.99


@pytest.mark.parametrize("folded", [False, True])
def test_text_trees_match_jax(folded):
    """The text tower's trees: unfolded bit for bit; folded with int8
    weights equal, scales within 1 ulp, biases to the fold's sum order."""
    jp = _params(7)
    heads = {"visual": H, "text": H} if folded else None
    ref = jquant.quantize_clip_params(jp, fold=folded, heads=heads)["text"]
    got = tquant.quantize_clip_params(tclip.params_from_numpy(jp), fold=folded,
                                      heads=heads)["text"]
    assert got["quant_folded"] is folded
    for half, names in (("attn", ("w_qkv", "w_out")), ("mlp", ("c_fc", "c_proj"))):
        for n in names:
            r, g = ref[half][n], got[half][n]
            np.testing.assert_array_equal(g.w_int8.numpy(), np.asarray(r.w_int8), err_msg=n)
            if folded:
                np.testing.assert_array_max_ulp(g.w_scale.numpy(), np.asarray(r.w_scale), 1)
                np.testing.assert_allclose(g.bias.numpy(), np.asarray(r.bias), rtol=1e-5,
                                           atol=1e-6, err_msg=n)
            else:
                np.testing.assert_array_equal(g.w_scale.numpy(), np.asarray(r.w_scale), err_msg=n)
                np.testing.assert_array_equal(g.bias.numpy(), np.asarray(r.bias), err_msg=n)


# ---------------------------------------------------------------------------
# the repairs: route, text defaults, quantization default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res,patch", [(64, 16), (224, 32)])
def test_unfolded_image_tower_takes_the_fused_route(monkeypatch, res, patch):
    """``encode_image(quant=unfolded)`` below 128 tokens (S = 17, 50) with
    no LoRA context takes the fused tower, as the JAX package's chip gate
    does: K3 + K4 on every layer, neither ``int8_linear`` nor K7."""
    jp = _params(8, E, res, patch)
    tp = tclip.params_from_numpy(jp)
    quant = tquant.quantize_clip_params(tp)["visual"]

    def refuse(*a, **k):
        raise AssertionError("the composable route ran")

    for module, name in ((tattn, "int8_linear"), (tlayers, "int8_linear"),
                         (tattn, "packed_attention")):
        monkeypatch.setattr(module, name, refuse)
    calls = []
    for name in ("attn_half_int8", "mlp_half_int8"):
        fn = getattr(tbk, name)
        monkeypatch.setattr(tbk, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    images = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 3, res, res)).astype(np.float32))
    out = tclip.encode_image(tp, tclip.CLIPConfig(**_cfg(E, res, patch)), images,
                             dtype=torch.bfloat16, quant=quant)
    assert out.shape == (2, 32) and bool(out.float().isfinite().all())
    assert calls == ["attn_half_int8", "mlp_half_int8"] * 2


@pytest.mark.parametrize("s", [17, 50])
def test_unfolded_tower_matches_jax_fused(s):
    """The same route against JAX's ``run_fused_tower(quant=unfolded,
    interpret=True)`` on [B, S, E] bf16 activations (every row)."""
    jp = _params(9)
    jb, jq, tb, tq = _tower(jp, "visual", False, H)
    x = _rows(9, CROPS * s)
    ref = jbk.run_fused_tower(_jx(x).reshape(CROPS, s, E), jax.tree_util.tree_map(jnp.asarray, jb),
                              H, None, quant=jq, interpret=True)
    got = tclip._run_blocks(x.reshape(CROPS, s, E), tb, H, None, quant=tq)
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy().reshape(-1, E), _np(ref).reshape(-1, E), 5e-2)


_JAX_STRICT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.ops import quant as jquant
d = np.load(sys.argv[1], allow_pickle=True).item()
blocks = jax.tree_util.tree_map(jnp.asarray, d["params"]["visual"]["blocks"])
quant = jquant.quantize_clip_params(d["params"])["visual"]
out = jbk.run_fused_tower(jnp.asarray(d["x"]).astype(jnp.bfloat16), blocks, d["heads"], None,
                          quant=quant, interpret=True)
np.save(sys.argv[2], np.asarray(out.astype(jnp.float32)))
"""


def test_unfolded_tower_strict_bf16(tmp_path):
    """The route against a strict bf16 JAX run (a subprocess with
    ``--xla_allow_excess_precision=false``): the fused halves stay within
    1 bf16 ulp + 1e-3 on all but 1e-2 of the elements and equal on all but
    2e-2; the composable route (``int8_linear``: division, another cast
    order) differs on most of them."""
    jp = _params(9)
    s = 17
    x = _rows(9, CROPS * s).float().numpy().reshape(CROPS, s, E)
    np.save(tmp_path / "in.npy", {"params": jp, "x": x, "heads": H}, allow_pickle=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_STRICT, str(tmp_path / "in.npy"),
                    str(tmp_path / "out.npy")], cwd=ROOT, env=env, check=True, timeout=600)
    ref = np.load(tmp_path / "out.npy").reshape(-1, E)
    tp = tclip.params_from_numpy(jp)
    got = tclip._run_blocks(torch.from_numpy(x).bfloat16(), tp["visual"]["blocks"], H, None,
                            quant=tquant.quantize_clip_params(tp)["visual"])
    got = got.float().numpy().reshape(-1, E)
    over = np.abs(got - ref) > 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3
    assert over.mean() <= 1e-2 and (got != ref).mean() <= 2e-2, (over.mean(), (got != ref).mean())


def test_text_entry_points_default_to_f32():
    """``encode_text``, ``encode_text_embeddings``, ``encode_class_templates``
    and ``build_classifier_weights`` default to f32, as the JAX package's;
    with defaults ``encode_text`` agrees with JAX's default call."""
    for fn in (tclip.encode_text, tclip.encode_text_embeddings, tcls.encode_class_templates,
               tcls.build_classifier_weights):
        assert inspect.signature(fn).parameters["dtype"].default is torch.float32, fn.__name__
    jp = _params(10)
    ids = _ids(10)
    ref = _np(jclip.encode_text(jp, jclip.CLIPConfig(**_cfg()), jnp.asarray(ids), impl="fused"))
    got = tclip.encode_text(tclip.params_from_numpy(jp), tclip.CLIPConfig(**_cfg()), ids,
                            device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4)


def test_quantize_clip_params_defaults_as_jax():
    """``quantize_clip_params(params)`` gives JAX's default: both towers,
    unfolded, bit for bit."""
    jp = _params(11)
    ref = jquant.quantize_clip_params(jp)
    got = tquant.quantize_clip_params(tclip.params_from_numpy(jp))
    assert set(got) == set(ref) == {"visual", "text"}
    for tower in ("visual", "text"):
        assert got[tower]["quant_folded"] is False
        for half, n in (("attn", "w_qkv"), ("attn", "w_out"), ("mlp", "c_fc"), ("mlp", "c_proj")):
            for field in ("w_int8", "w_scale", "bias"):
                np.testing.assert_array_equal(getattr(got[tower][half][n], field).numpy(),
                                              np.asarray(getattr(ref[tower][half][n], field)))


# ---------------------------------------------------------------------------
# the odd-head float tower
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_heads,dtype", [(1, torch.float32), (3, torch.float32),
                                           (3, torch.bfloat16)])
def test_odd_head_float_tower_matches_jax(n_heads, dtype):
    """``run_float_tower`` mask-free with an odd head count (K6a's per-head
    ``use_mask=True`` route, a zero bias) vs ``run_fused_tower(quant=None)``
    in interpret mode: f32 to 1e-4, bf16 at row cos >= 0.999."""
    e = 64 * n_heads
    jp = _params(12, e)
    jb = jp["visual"]["blocks"]
    tb = tclip.params_from_numpy(jp)["visual"]["blocks"]
    s = 17
    x = _rows(12, CROPS * s, e, dtype)
    ref = _np(jbk.run_fused_tower(_jx(x).reshape(CROPS, s, e), jax.tree_util.tree_map(jnp.asarray, jb),
                                  n_heads, None, interpret=True)).reshape(-1, e)
    got = tbk.run_float_tower(x, tb, n_heads, s=s, causal=False)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    else:
        _close_bf16(got.float().numpy(), ref, 5e-2)
