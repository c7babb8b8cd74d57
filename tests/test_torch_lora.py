"""K7 (the packed-qkv attention), LoRA and the LoRA files of the port
against the JAX package on the CPU.

K7's forward is held against ``packed_attention(..., interpret=True)``
(the Pallas kernel ``_packed_attn_kernel`` in interpret mode) and its
gradients, through the port's autograd Function on CPU tensors (the
plain backward), against ``jax.grad`` of the JAX function (the XLA VJP of
``_packed_attention_ref``): f32 within atol 1e-5, as
``tests/test_ops.py:117-157``. bf16 uses the bars of
``tests/test_torch_text.py`` (min row cos >= 0.999, atol = rtol = 5e-2):
CPU XLA keeps bf16 intermediates in f32, so the two sides round at other
points. LoRA: the same factors from a seed, the same merge, the same
decomposed branch given JAX's dropout masks; the files load in either
package."""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import attention as jattn
from jcf_tpu.peft import lora as jlora
from jcf_tpu.peft import lora_io as jlora_io
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import attention as tattn
from jcf_tpu_torch.peft import lora as tlora
from jcf_tpu_torch.peft import lora_io as tlora_io

torch.set_num_threads(1)

SMALL = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=8, context_length=77, vocab_size=1000, text_width=96,
    text_heads=3, text_layers=2,
)
SPEC = jlora.LoraSpec(r=2, alpha=1.0, dropout_rate=0.25, params=("q", "k", "v"),
                      encoder="both", position="bottom", backbone="ViT-B/16")


def _tspec(spec):
    return tlora.LoraSpec(**{f: getattr(spec, f) for f in
                             ("r", "alpha", "dropout_rate", "params", "encoder", "position",
                              "backbone")})


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    g2, r2 = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    cos = ((g2 * r2).sum(-1) / (np.linalg.norm(g2, axis=-1) * np.linalg.norm(r2, axis=-1) + 1e-9))
    keep = np.linalg.norm(r2, axis=-1) > 1e-6  # rows the causal mask leaves exactly zero
    assert cos[keep].min() >= 0.999, cos[keep].min()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def _qkv(seed, b, s, e):
    return np.random.default_rng(seed).standard_normal((b, s, 3 * e)).astype(np.float32)


def _bias(causal, s):
    return np.array(jattn.causal_mask(s)) if causal else None


def _jax_out_and_grad(qkv, heads, bias, cot, dtype):
    qj = jnp.asarray(qkv).astype(dtype)
    bj = None if bias is None else jnp.asarray(bias)
    out = jattn.packed_attention(qj, heads, bj, interpret=True)
    grad = jax.grad(lambda q: jnp.sum(jattn.packed_attention(q, heads, bj, interpret=True)
                                      .astype(jnp.float32) * cot))(qj)
    return _np(out), _np(grad)


def _port_out_and_grad(qkv, heads, bias, cot, dtype):
    x = torch.from_numpy(qkv).to(dtype).requires_grad_(True)
    out = tattn.packed_attention(x, heads, None if bias is None else torch.from_numpy(bias))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == dtype and x.grad.dtype == dtype
    return out.detach().float().numpy(), x.grad.float().numpy()


# (heads, head dim): an even and an odd head count
@pytest.mark.parametrize("heads,d", [(2, 32), (3, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_k7_f32_matches_jax(heads, d, causal):
    """Forward vs the Pallas kernel in interpret mode, gradients vs
    ``jax.grad``: atol 1e-5."""
    s = 77 if causal else 50
    qkv = _qkv(heads + s, 3, s, heads * d)
    cot = np.random.default_rng(s).standard_normal((3, s, heads * d)).astype(np.float32)
    ref_out, ref_grad = _jax_out_and_grad(qkv, heads, _bias(causal, s), cot, jnp.float32)
    out, grad = _port_out_and_grad(qkv, heads, _bias(causal, s), cot, torch.float32)
    np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads,d", [(2, 32), (3, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_k7_bf16_matches_jax(heads, d, causal):
    s = 77 if causal else 50
    qkv = _qkv(heads + s + 1, 3, s, heads * d)
    cot = np.random.default_rng(s + 1).standard_normal((3, s, heads * d)).astype(np.float32)
    ref_out, ref_grad = _jax_out_and_grad(qkv, heads, _bias(causal, s), cot, jnp.bfloat16)
    out, grad = _port_out_and_grad(qkv, heads, _bias(causal, s), cot, torch.bfloat16)
    _close(out, ref_out)
    _close(grad, ref_grad)


def test_k7_f32_at_text_width_matches_jax():
    """ViT-B/32's text attention: E = 512, 8 heads, 77 tokens, causal."""
    qkv = _qkv(7, 2, 77, 512)
    cot = np.random.default_rng(8).standard_normal((2, 77, 512)).astype(np.float32)
    ref_out, ref_grad = _jax_out_and_grad(qkv, 8, _bias(True, 77), cot, jnp.float32)
    out, grad = _port_out_and_grad(qkv, 8, _bias(True, 77), cot, torch.float32)
    np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_k7_plain_backward_matches_autograd(dtype, causal):
    """The backward kernel's plain version vs autograd through the plain
    forward: f32 within 1e-6; bf16 within one bf16 ulp + 1e-3."""
    s, heads = 50, 3
    x = torch.from_numpy(_qkv(3, 4, s, heads * 32)).to(dtype).requires_grad_(True)
    bias = tattn.causal_mask(s) if causal else None
    dout = torch.randn(4, s, heads * 32, generator=torch.Generator().manual_seed(1)).to(dtype)
    ref, = torch.autograd.grad(tattn.packed_attention_plain(x, heads, bias), x, dout)
    got = tattn.packed_attention_bwd_plain(x.detach(), heads, tattn._full_bias(s, x.device, bias), dout)
    assert got.dtype == dtype and got.shape == x.shape
    g, r = got.float(), ref.float()
    tol = 1e-6 if dtype == torch.float32 else 2.0**-8 * g.abs().maximum(r.abs()) + 1e-3
    assert bool(((g - r).abs() <= tol).all())


def test_k7_bias_is_additive_and_causal_mask_masks():
    """A causal bias leaves earlier rows unchanged when later keys change;
    any bias is taken as given (not assumed causal)."""
    s, heads = 30, 2
    qkv = torch.from_numpy(_qkv(4, 2, s, 64))
    base = tattn.packed_attention(qkv, heads, tattn.causal_mask(s))
    qkv2 = qkv.clone()
    qkv2[:, 20:, 64:] = torch.randn(2, s - 20, 128)
    out = tattn.packed_attention(qkv2, heads, tattn.causal_mask(s))
    assert torch.equal(out[:, :20], base[:, :20]) and not torch.equal(out[:, 20:], base[:, 20:])
    band = np.where(np.abs(np.subtract.outer(np.arange(s), np.arange(s))) <= 3, 0.0,
                    -np.inf).astype(np.float32)
    ref = _np(jattn.packed_attention(jnp.asarray(qkv.numpy()), heads, jnp.asarray(band),
                                     interpret=True))
    got = tattn.packed_attention(qkv, heads, torch.from_numpy(band)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_multi_head_attention_refuses_k8_lengths():
    """K8 (128 tokens or more) has no backward: a LoRA training context
    there is refused."""
    x = torch.zeros(1, 128, 64)
    p = {"w_qkv": torch.zeros(192, 64), "b_qkv": torch.zeros(192),
         "w_out": torch.zeros(64, 64), "b_out": torch.zeros(64)}
    with pytest.raises(NotImplementedError):
        tattn.multi_head_attention(x, p, 2, lora={"layer": {}})


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [("q", "k", "v"), ("q", "v", "o")])
@pytest.mark.parametrize("encoder", ["both", "text", "vision"])
def test_init_lora_params_match_jax(params, encoder):
    js = jlora.LoraSpec(r=3, params=params, encoder=encoder)
    ref = jlora.init_lora_params(5, js, 2, 96, 3, 64)
    got = tlora.init_lora_params(5, _tspec(js), 2, 96, 3, 64)
    assert set(got) == set(ref)
    for t in ref:
        assert set(got[t]) == set(ref[t])
        for k in ref[t]:
            assert got[t][k].dtype == torch.float32
            np.testing.assert_array_equal(got[t][k].numpy(), np.asarray(ref[t][k]))


@pytest.mark.parametrize("spec", [SPEC, jlora.LoraSpec(params=("q", "v"), position="half-up"),
                                  jlora.LoraSpec(encoder="text", position="top1")])
def test_lora_layer_masks_match_jax(spec):
    ref = jlora.lora_layer_masks(spec, 12, 12)
    got = tlora.lora_layer_masks(_tspec(spec), 12, 12)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def _random_lora(spec, seed, cfg=SMALL):
    """Factors with B drawn too (B = 0 at init would make every branch 0)."""
    lora = jax.tree_util.tree_map(np.array, jlora.init_lora_params(
        seed, spec, cfg["text_layers"], cfg["text_width"], cfg["vision_layers"],
        cfg["vision_width"]))
    rng = np.random.default_rng(seed + 50)
    for tower in lora.values():
        for k in [k for k in tower if k.startswith("b_")]:
            tower[k] = (0.05 * rng.standard_normal(tower[k].shape)).astype(np.float32)
    return lora


def _to_torch(tree):
    return {k: _to_torch(v) for k, v in tree.items()} if isinstance(tree, dict) else _t(tree)


@pytest.mark.parametrize("params", [("q", "k", "v"), ("k", "o")])
def test_merge_lora_params_matches_jax(params):
    spec = jlora.LoraSpec(r=2, params=params, position="bottom", backbone="ViT-B/16")
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(0, jclip.CLIPConfig(**SMALL)))
    lora = _random_lora(spec, 3)
    ref = jlora.merge_lora_params(jp, lora, spec)
    got = tlora.merge_lora_params(_to_torch(jp), _to_torch(lora), _tspec(spec))
    for tower in ("text", "visual"):
        for k in ("w_qkv", "w_out"):
            np.testing.assert_allclose(got[tower]["blocks"]["attn"][k].numpy(),
                                       np.asarray(ref[tower]["blocks"]["attn"][k]),
                                       rtol=1e-6, atol=1e-7)
    # the input tree is not modified
    np.testing.assert_array_equal(_to_torch(jp)["text"]["blocks"]["attn"]["w_qkv"].numpy(),
                                  jp["text"]["blocks"]["attn"]["w_qkv"])


@pytest.mark.parametrize("params", [("q", "k", "v"), ("q", "v", "o")])
def test_lora_adjustments_match_jax_with_its_masks(params, monkeypatch):
    """The decomposed branch of one layer, given the keep masks JAX draws
    for the same key (the port's draw is replaced by them)."""
    spec = jlora.LoraSpec(r=2, params=params, dropout_rate=0.25)
    lora = _random_lora(spec, 4)["text"]
    layer = {k: v[1] for k, v in lora.items()}
    x = np.random.default_rng(9).standard_normal((3, 11, 96)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    proj = jnp.asarray([1.0 if p in params else 0.0 for p in "qkv"], jnp.float32)
    masks = [np.asarray(jax.random.bernoulli(key, 0.75, (3,) + x.shape)),
             np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 3), 0.75, x.shape))]
    drawn = []

    def jax_masks(generator, keep, shape, device):
        m = masks[len(drawn)]
        assert keep == 0.75 and tuple(shape) == m.shape
        drawn.append(shape)
        return torch.from_numpy(m)

    monkeypatch.setattr(tlora, "dropout_keep_masks", jax_masks)
    tl = {k: _t(v) for k, v in layer.items()}
    gen = torch.Generator().manual_seed(0)
    ref = jlora.lora_qkv_adjustment(jnp.asarray(x), layer, spec, 1.0, proj, key)
    got = tlora.lora_qkv_adjustment(_t(x), tl, _tspec(spec), 1.0, _t(proj),
                                    gen)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    if "o" in params:
        ref_o = jlora.lora_out_adjustment(jnp.asarray(x), layer, spec, 1.0, key)
        got_o = tlora.lora_out_adjustment(_t(x), tl, _tspec(spec), 1.0, gen)
        np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), rtol=1e-5, atol=1e-7)
    assert len(drawn) == (2 if "o" in params else 1)


def test_dropout_keep_masks_statistics():
    """Port-only: keep rate 0.75 and surviving inputs scaled by 1/keep."""
    gen = torch.Generator().manual_seed(0)
    masks = tlora.dropout_keep_masks(gen, 0.75, (3, 64, 50, 128), "cpu")
    assert masks.dtype == torch.bool
    assert abs(float(masks.float().mean()) - 0.75) < 2e-3
    # the three projections draw independent masks
    agree = float((masks[0] == masks[1]).float().mean())
    assert abs(agree - (0.75**2 + 0.25**2)) < 5e-3
    spec = tlora.LoraSpec(r=1)
    x = torch.ones(2, 7, 16)
    layer = {"a_qkv": torch.ones(3, 1, 16), "b_qkv": torch.zeros(3, 16, 1)}
    layer["b_qkv"][:, 0, 0] = 1.0
    adj = tlora.lora_qkv_adjustment(x, layer, spec, 1.0, torch.ones(3), gen)
    # column 0 of each projection sums the dropped-and-scaled ones: 16 x
    # keep x (1 / keep) on average
    kept = adj.reshape(2, 7, 3, 16)[..., 0] / spec.scaling
    assert float(kept.mean()) == pytest.approx(16.0, rel=0.05)
    scaled = kept * 0.75  # an integer: a count of kept ones, each 1 / keep
    assert float((scaled - scaled.round()).abs().max()) < 1e-4


def _small_cfgs():
    return jclip.CLIPConfig(**SMALL), tclip.CLIPConfig(**SMALL)


def _ids(seed, b=4):
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, 77), np.int32)
    for i in range(b):
        n = int(rng.integers(3, 20))
        ids[i, 0] = SMALL["vocab_size"] - 2
        ids[i, 1 : n + 1] = rng.integers(1, SMALL["vocab_size"] - 2, n)
        ids[i, n + 1] = SMALL["vocab_size"] - 1
    return ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_towers_match_jax(dtype):
    """``encode_text`` and ``encode_image`` on the LoRA route (no dropout)
    vs the JAX functions with ``impl="xla"``: f32 within 1e-5, bf16 by the
    bars of test_torch_text.py."""
    jcfg, tcfg = _small_cfgs()
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(1, jcfg))
    lora = _random_lora(SPEC, 2)
    tp, tl = _to_torch(jp), _to_torch(lora)
    ids = _ids(3)
    images = np.random.default_rng(4).standard_normal((3, 3, 32, 32)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_t = _np(jclip.encode_text(jp, jcfg, jnp.asarray(ids), dtype=jdt, impl="xla",
                                  lora_ctx=jlora.make_lora_context(lora, SPEC, "text", 2)))
    ref_v = _np(jclip.encode_image(jp, jcfg, jnp.asarray(images), dtype=jdt, impl="xla",
                                   lora_ctx=jlora.make_lora_context(lora, SPEC, "vision", 2)))
    got_t = tclip.encode_text(tp, tcfg, ids, device="cpu", dtype=tdt,
                              lora_ctx=tlora.make_lora_context(tl, _tspec(SPEC), "text", 2))
    got_v = tclip.encode_image(tp, tcfg, torch.from_numpy(images), dtype=tdt,
                               lora_ctx=tlora.make_lora_context(tl, _tspec(SPEC), "vision", 2))
    assert got_t.dtype == got_v.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got_t.numpy(), ref_t, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got_v.numpy(), ref_v, atol=1e-5, rtol=1e-5)
    else:
        _close(got_t.float().numpy(), ref_t)
        _close(got_v.float().numpy(), ref_v)


def test_merged_equals_decomposed():
    """Port-only: the towers with the factors merged into the weights equal
    the decomposed branch without dropout (f32, within 1e-5)."""
    jcfg, tcfg = _small_cfgs()
    tp = _to_torch(jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(2, jcfg)))
    jspec = jlora.LoraSpec(r=2, params=("q", "k", "v", "o"), position="bottom",
                           backbone="ViT-B/16")
    spec, tl = _tspec(jspec), _to_torch(_random_lora(jspec, 5))
    merged = tlora.merge_lora_params(tp, tl, spec)
    ids = _ids(6)
    images = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    dec_t = tclip.encode_text(tp, tcfg, ids, device="cpu", dtype=torch.float32,
                              lora_ctx=tlora.make_lora_context(tl, spec, "text", 2))
    dec_v = tclip.encode_image(tp, tcfg, images,
                               lora_ctx=tlora.make_lora_context(tl, spec, "vision", 2))
    # the merged tree through the same composable route, its factors zero
    zeros = {t: {k: torch.zeros_like(v) for k, v in d.items()} for t, d in tl.items()}
    mer_t = tclip.encode_text(merged, tcfg, ids, device="cpu", dtype=torch.float32,
                              lora_ctx=tlora.make_lora_context(zeros, spec, "text", 2))
    mer_v = tclip.encode_image(merged, tcfg, images)
    np.testing.assert_allclose(mer_t.numpy(), dec_t.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mer_v.numpy(), dec_v.numpy(), atol=1e-5, rtol=1e-5)


def test_gradients_reach_only_enabled_projections():
    """Port-only: a 6-layer text tower with LoRA on q and v of layers 0-3
    ("bottom"): the factors of k and of layers 4-5 get zero gradient, the
    others do not."""
    cfg = tclip.CLIPConfig(**{**SMALL, "text_layers": 6})
    tp = tclip.init_clip_params(0, cfg)
    spec = tlora.LoraSpec(r=2, params=("q", "v"), encoder="text", position="bottom")
    tl = tlora.init_lora_params(1, spec, 6, SMALL["text_width"], 2, SMALL["vision_width"])
    tl["text"]["b_qkv"] = 0.05 * torch.randn(tl["text"]["b_qkv"].shape,
                                             generator=torch.Generator().manual_seed(2))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tl["text"].items()}
    ctx = tlora.make_lora_context({"text": leaves}, spec, "text", 6,
                                  generator=torch.Generator().manual_seed(3))
    out = tclip.encode_text(tp, cfg, _ids(7), device="cpu", dtype=torch.float32, lora_ctx=ctx)
    (out * torch.randn(out.shape, generator=torch.Generator().manual_seed(4))).sum().backward()
    for k in ("a_qkv", "b_qkv"):
        g = leaves[k].grad
        assert float(g[4:].abs().max()) == 0.0 and float(g[:, 1].abs().max()) == 0.0, k
        for layer in range(4):
            for proj in (0, 2):
                assert float(g[layer, proj].abs().max()) > 0.0, (k, layer, proj)
    assert tlora.make_lora_context({"text": leaves}, spec, "vision", 2) is None


# ---------------------------------------------------------------------------
# LoRA files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [("q", "k", "v"), ("q", "v", "o")])
def test_lora_files_load_in_either_package(tmp_path, params):
    spec = jlora.LoraSpec(r=2, params=params, position="bottom", backbone="ViT-B/16")
    lora = _random_lora(spec, 8)
    kw = dict(n_text=2, n_vision=2)
    widths = dict(text_width=SMALL["text_width"], vision_width=SMALL["vision_width"])
    jlora_io.save_lora(jax.tree_util.tree_map(jnp.asarray, lora), spec, str(tmp_path / "j.pkl"), **kw)
    tlora_io.save_lora(_to_torch(lora), _tspec(spec), str(tmp_path / "t.pkl"), **kw)
    # the same bytes: a pickle of the same dict of f32 numpy arrays
    assert (tmp_path / "j.pkl").read_bytes() == (tmp_path / "t.pkl").read_bytes()
    from_j = tlora_io.load_lora(str(tmp_path / "j.pkl"), _tspec(spec), **kw, **widths)
    from_t = jlora_io.load_lora(str(tmp_path / "t.pkl"), spec, **kw, **widths)
    # the file holds the spec's projections; the others load as zeros
    for tower in lora.values():
        for pi, p in enumerate("qkv"):
            if p not in params:
                tower["a_qkv"][:, pi] = 0.0
                tower["b_qkv"][:, pi] = 0.0
    for t in lora:
        for k in lora[t]:
            np.testing.assert_array_equal(from_j[t][k].numpy(), lora[t][k])
            np.testing.assert_array_equal(np.asarray(from_t[t][k]), lora[t][k])
    with pytest.raises(ValueError):
        tlora_io.load_lora(str(tmp_path / "j.pkl"), _tspec(jlora.LoraSpec(r=4, params=params)),
                           **kw, **widths)
    with pytest.raises(FileNotFoundError):
        tlora_io.load_lora(str(tmp_path / "none.pkl"), _tspec(spec), **kw, **widths)


def test_lora_swa_loads_in_either_package(tmp_path):
    spec = SPEC
    kw = dict(n_text=2, n_vision=2)
    widths = dict(text_width=SMALL["text_width"], vision_width=SMALL["vision_width"])
    folder = tmp_path / "swa"
    os.makedirs(folder)
    loras = [_random_lora(spec, s) for s in (10, 11, 12)]
    jlora_io.save_lora(jax.tree_util.tree_map(jnp.asarray, loras[0]), spec, str(folder / "a.pkl"),
                       **kw)
    tlora_io.save_lora(_to_torch(loras[1]), _tspec(spec), str(folder / "b.pkl"), **kw)
    tlora_io.save_lora(_to_torch(loras[2]), _tspec(spec), str(folder / "c.pkl"), **kw)
    os.makedirs(folder / "subdir")  # skipped
    ref = jlora_io.load_lora_swa(str(folder), spec, **kw, **widths)
    got = tlora_io.load_lora_swa(str(folder), _tspec(spec), **kw, **widths)
    for t in ref:
        for k in ref[t]:
            np.testing.assert_array_equal(got[t][k].numpy(), np.asarray(ref[t][k]))
            np.testing.assert_allclose(got[t][k].numpy(),
                                       np.mean([lo[t][k] for lo in loras], axis=0),
                                       rtol=1e-6, atol=1e-7)
    with open(folder / "a.pkl", "rb") as f:
        assert set(pickle.load(f)["metadata"]) == {"r", "alpha", "encoder", "params", "position"}
    with pytest.raises(ValueError):
        tlora_io.load_lora_swa(str(folder / "subdir"), _tspec(spec), **kw, **widths)
