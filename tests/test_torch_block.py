"""K3/K4/K5 and the tower loop: the port's plain int8 tower (dense rows,
``cls_only``, folded weights, static scales in mode "full", the last
layer through K5 as ``_CLS_ATTNQ = True``) vs ``run_fused_tower`` in
interpret mode, with
the bars of ``test_block_kernel.py:461-466``: min row cos >= 0.999 and
atol = rtol = 5e-2 (int8 values can flip at rounding boundaries where the
two sides' f32 sums and tanh differ in the last bits). The halves, the
attention and the LN quant are held against their JAX counterparts too."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import quant as jquant
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.layers import layer_slice
from jcf_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

SMALL = dict(
    embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=8, vocab_size=100, text_width=64,
    text_heads=1, text_layers=1,
)
S, S_PAD, E, H, CROPS = 17, 32, 128, 2, 4


def _quant_trees(seed):
    """(JAX params, JAX folded static tree, port tree) from one seed."""
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(seed, jclip.CLIPConfig(**SMALL)))
    rng = np.random.default_rng(seed + 50)
    blocks = jp["visual"]["blocks"]
    for ln in ("ln_1", "ln_2"):
        blocks[ln]["scale"] = (1 + 0.1 * rng.standard_normal(blocks[ln]["scale"].shape)).astype(np.float32)
        blocks[ln]["bias"] = (0.1 * rng.standard_normal(blocks[ln]["bias"].shape)).astype(np.float32)
    imgs = rng.random((4, 3, 64, 64)).astype(np.float32)
    amax = np.asarray(jclip.vision_ln_z_amax(jp, jclip.CLIPConfig(**SMALL), jnp.asarray(imgs)))
    heads = {"visual": H, "text": 1}
    jq = jquant.quantize_clip_params(jp, fold=True, heads=heads, act_scales={"visual": amax},
                                     act_static=("ctx", "hidden"))["visual"]
    tq = tquant.quantize_clip_params(tclip.params_from_numpy(jp), fold=True, heads=heads,
                                     act_scales={"visual": torch.tensor(amax)})["visual"]
    return jp, jq, tq


def _rows(seed, crops=CROPS):
    x = np.random.default_rng(seed + 7).standard_normal((crops * S, E)).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    cos = ((got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1) + 1e-9)).min()
    assert cos >= 0.999, cos
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def _jax_layer(jp, jq, i):
    return (jax.tree_util.tree_map(lambda a: a[i], jp["visual"]["blocks"]),
            jax.tree_util.tree_map(lambda a: a[i], jq))


def _bias():
    return jnp.full((S_PAD, S_PAD), jbk._NEG_INF, jnp.float32).at[:S, :S].set(0.0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_tower_matches_jax(seed):
    jp, jq, tq = _quant_trees(seed)
    x = _rows(seed)
    ref = jbk.run_fused_tower(_to_jax(x), jp["visual"]["blocks"], H, None, quant=jq,
                              quant_folded=True, interpret=True, flat_s=S, cls_only=True)
    got = tbk.run_fused_tower(x, tq, H, flat_s=S)
    assert got.shape == (CROPS, E) and got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_halves_match_jax(seed, layer):
    """One full layer: K3 then K4 on all rows (the dense halves kernels)."""
    jp, jq, tq = _quant_trees(seed)
    x = _rows(seed)
    lp, lq = _jax_layer(jp, jq, layer)
    kw = dict(s_real=S, use_mask=False, quant_folded=True, dense=True, s_pad=S_PAD)
    ref_mid = jbk._halves_block(_to_jax(x), lp, H, _bias(), lq, True, mlp_half=False, **kw)
    ref_out = jbk._halves_block(_to_jax(x), lp, H, _bias(), lq, True, **kw)
    t_layer = layer_slice(tq, layer)
    mid = tbk.attn_half_int8(x, t_layer["attn"], S, H)
    out = tbk.mlp_half_int8(mid, t_layer["mlp"])
    _close(mid.float().numpy(), np.asarray(ref_mid.astype(jnp.float32)))
    _close(out.float().numpy(), np.asarray(ref_out.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_mlp_half_on_cls_rows_matches_jax(seed):
    """The last layer's MLP half on gathered rows (``_mlp_half_cls_rows``,
    XLA in the JAX package) runs on the port's K4 at M = B' rows."""
    jp, jq, tq = _quant_trees(seed)
    mid = _rows(seed, crops=8)[::S].contiguous()
    lp, lq = _jax_layer(jp, jq, 1)
    ref = jbk._mlp_half_cls_rows(_to_jax(mid), lp, lq, quant_folded=True)
    got = tbk.mlp_half_int8(mid, layer_slice(tq, 1)["mlp"])
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_attention_matches_jax_paired(seed):
    """Pair shift, bf16 p, post-PV normalizer with ctx_inv, round-clip:
    the int8 context vs ``_paired_attention_nomask`` on the padded layout."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((CROPS * S, 3 * E)).astype(np.float32)).bfloat16()
    ctx_inv = torch.tensor([[40.0]])
    q3 = np.zeros((CROPS, S_PAD, 3 * E), np.float32)
    q3[:, :S] = qkv.float().numpy().reshape(CROPS, S, 3 * E)
    ref = jbk._paired_attention_nomask(jnp.asarray(q3).astype(jnp.bfloat16), H, E // H, None,
                                       CROPS, S_PAD, s_real=S, post_scale=jnp.float32(40.0))
    ref = np.asarray(ref).reshape(CROPS, S_PAD, E)[:, :S].reshape(CROPS * S, E)
    ref = np.clip(np.round(ref), -127, 127).astype(np.int32)
    got = tbk.attention(qkv, ctx_inv, S, H)
    assert got.dtype == torch.int8 and got.shape == (CROPS * S, E)
    d = np.abs(got.numpy().astype(np.int32) - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 2e-2, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_ln_quant_matches_jax(seed):
    x = _rows(seed, crops=16)
    inv = 127.0 / 4.3
    ref = np.asarray(jbk._quant_rows_static(jbk._ln_norm(_to_jax(x)), jnp.float32(inv)))
    got = tbk.ln_quant(x, torch.tensor([[inv]], dtype=torch.float32))
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3



@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_attn_cls_matches_jax(seed):
    """K5 (LN + quant on all rows, K/V on all rows, Q on the CLS rows,
    CLS-query attention, out-proj + residual on the CLS rows) vs
    ``_attn_cls_dense`` in interpret mode. The int8 GEMMs are exact and
    both sides run the same f32 epilogue ops, so the bf16 outputs are
    equal wherever the int8 context is: all but a few elements that sit
    on rounding ties."""
    jp, jq, tq = _quant_trees(seed)
    x = _rows(seed, crops=8)
    lp, lq = _jax_layer(jp, jq, 1)
    ref = jbk._attn_cls_dense(_to_jax(x), lp, H, lq, True, s_real=S, quant_folded=True)
    got = tbk.attn_cls_int8(x, layer_slice(tq, 1)["attn"], S, H)
    assert got.shape == (8, E) and got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    _close(got.float().numpy(), ref)
    assert (got.float().numpy() != ref).mean() <= 2e-2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_cls_attention_shift_and_normalizer(seed):
    """The CLS-query context against the full-row attention's CLS rows:
    both take the pair shift max(0, pair max) and PV on bf16 p, but K5
    sums the f32 p and K3 the bf16 p, so they agree to one int8 step."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((CROPS * S, 3 * E)).astype(np.float32)).bfloat16()
    ctx_inv = torch.tensor([[40.0]])
    full = tbk.attention(qkv, ctx_inv, S, H)[::S]
    cls = tbk.cls_attention(qkv[::S, :E].contiguous(), qkv[:, E:].contiguous(), ctx_inv, S, H)
    assert cls.dtype == torch.int8 and cls.shape == (CROPS, E)
    d = (cls.int() - full.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 5e-2
