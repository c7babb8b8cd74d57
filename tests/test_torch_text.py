"""The text tower of the port (K6a/K6b and ``encode_text``): the plain
versions vs the JAX package's bf16 fused route in interpret mode
(``_ln_rows``, ``_paired_attention`` with the causal mask,
``_halves_block``, ``run_fused_tower`` and ``encode_text(..., dtype=bf16,
impl="fused")``) on the same weights and inputs, with the bars of
``test_block_kernel.py:461-466``: min row cos >= 0.999 and atol = rtol =
5e-2. Where the two sides round at the same points the rows also agree
to one bf16 ulp.

CPU XLA keeps bf16 intermediates in f32 (``xla_allow_excess_precision``);
``test_encode_text_strict_bf16`` runs the JAX side in a subprocess with
that off and holds the port to a tighter bar."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops.attention import causal_mask
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import bf16_gemm as tbg
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.attention import causal_mask as t_causal_mask
from jcf_tpu_torch.ops.layers import layer_slice

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(
    embed_dim=32, image_resolution=64, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=1000, text_width=128,
    text_heads=2, text_layers=2,
)
S, S_PAD, E, H, B = 77, 80, 128, 2, 4


def _params(seed):
    """JAX-initialized params (numpy) with LN affines and biases made
    nonzero, so every epilogue term is exercised."""
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(seed, jclip.CLIPConfig(**SMALL)))
    rng = np.random.default_rng(seed + 100)
    blocks = jp["text"]["blocks"]
    for ln in ("ln_1", "ln_2"):
        blocks[ln]["scale"] = (1 + 0.1 * rng.standard_normal(blocks[ln]["scale"].shape)).astype(np.float32)
        blocks[ln]["bias"] = (0.1 * rng.standard_normal(blocks[ln]["bias"].shape)).astype(np.float32)
    for leaf in (blocks["attn"], blocks["mlp"]["c_fc"], blocks["mlp"]["c_proj"]):
        for k in [k for k in leaf if k.startswith("b")]:
            leaf[k] = (0.05 * rng.standard_normal(leaf[k].shape)).astype(np.float32)
    fin = jp["text"]["ln_final"]
    fin["scale"] = (1 + 0.1 * rng.standard_normal(fin["scale"].shape)).astype(np.float32)
    fin["bias"] = (0.1 * rng.standard_normal(fin["bias"].shape)).astype(np.float32)
    return jp


def _ids(seed, b=B):
    """Token ids shaped like tokenized prompts: SOT, words, EOT (the max
    id), zero padding; varied lengths."""
    rng = np.random.default_rng(seed + 7)
    ids = np.zeros((b, S), np.int32)
    for i in range(b):
        n = int(rng.integers(3, 20))
        ids[i, 0] = SMALL["vocab_size"] - 2
        ids[i, 1 : n + 1] = rng.integers(1, SMALL["vocab_size"] - 2, n)
        ids[i, n + 1] = SMALL["vocab_size"] - 1
    return ids


def _rows(seed, b=B, width=E):
    x = np.random.default_rng(seed + 11).standard_normal((b * S, width)).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    cos = ((got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1) + 1e-9)).min()
    assert cos >= 0.999, cos
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def _within_ulp(got, ref, frac=0.0, atol=0.0):
    """|got - ref| <= one bf16 ulp of the larger value + ``atol``, on all
    but ``frac`` of the elements."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    big = np.maximum(np.abs(got), np.abs(ref))
    bad = np.abs(got - ref) > np.ldexp(1.0, np.frexp(np.maximum(big, 1e-30))[1] - 8) + atol
    assert bad.mean() <= frac, bad.mean()


def _bias():
    """The TPU's additive mask: causal over the real rows, -1e30 on pad keys."""
    return jnp.full((S_PAD, S_PAD), jbk._NEG_INF, jnp.float32).at[:S, :S].set(causal_mask(S))


def _pad(x, b=B):
    """Port rows [B * S, E] -> the TPU's padded [B, S_PAD, E] layout."""
    x3 = np.zeros((b, S_PAD, x.shape[-1]), np.float32)
    x3[:, :S] = x.float().numpy().reshape(b, S, -1)
    return jnp.asarray(x3).astype(jnp.bfloat16)


def _unpad(y, b=B):
    return _np(y).reshape(b, S_PAD, -1)[:, :S].reshape(b * S, -1)


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(t_causal_mask(S).numpy(), np.asarray(causal_mask(S)))


@pytest.mark.parametrize("k", [E, 4 * E])
def test_plain_bf16_gemm_epilogues_match_jax(k):
    """The products of the bf16 halves as ``_attn_half_kernel`` and
    ``_mlp_half_kernel`` write them (bf16 operands, f32 accumulation, f32
    bias, ``_quick_gelu32``, f32 residual): within one bf16 ulp + 1e-3,
    the bar ``chip_smoke.py`` holds the kernels to (f32 sums in another
    order move outputs near zero by more than their own ulp)."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((B * S, k)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((E, k)) * k**-0.5).astype(np.float32)).bfloat16()
    bias = torch.from_numpy((0.1 * rng.standard_normal(E)).astype(np.float32))
    resid = _rows(k)
    acc = jax.lax.dot_general(_to_jax(a), _to_jax(w), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32) + jnp.asarray(bias.numpy())
    refs = {"bias": acc.astype(jnp.bfloat16),
            "gelu": jbk._quick_gelu32(acc).astype(jnp.bfloat16),
            "residual": (_to_jax(resid).astype(jnp.float32) + acc).astype(jnp.bfloat16)}
    gots = {"bias": tbg.bf16_gemm_bias(a, w, bias), "gelu": tbg.bf16_gemm_gelu(a, w, bias),
            "residual": tbg.bf16_gemm_residual(a, w, bias, resid)}
    for name, got in gots.items():
        assert got.dtype == torch.bfloat16, name
        _within_ulp(got.float().numpy(), _np(refs[name]), atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_ln_affine_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = _rows(seed)
    scale = (1 + 0.2 * rng.standard_normal(E)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(E)).astype(np.float32)
    ref = _np(jbk._ln_rows(_to_jax(x), jnp.asarray(scale).astype(jnp.bfloat16),
                           jnp.asarray(bias).astype(jnp.bfloat16)).astype(jnp.bfloat16))
    got = tbk.ln_affine(x, torch.from_numpy(scale).bfloat16(), torch.from_numpy(bias).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (B * S, E)
    _close(got.float().numpy(), ref)
    _within_ulp(got.float().numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_causal_attention_matches_jax(seed):
    """Per-head max, f32 softmax, p / sum in f32, bf16 p for PV, bf16
    context vs ``_paired_attention`` on the padded layout with the
    additive causal mask."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B * S, 3 * E)).astype(np.float32)).bfloat16()
    ref = jbk._paired_attention(_pad(qkv), _bias(), H, E // H, 1.0 / np.sqrt(E // H), B, S_PAD)
    ref = _unpad(ref.astype(jnp.bfloat16))
    got = tbk.causal_attention(qkv, S, H)
    assert got.dtype == torch.bfloat16 and got.shape == (B * S, E)
    _close(got.float().numpy(), ref)
    _within_ulp(got.float().numpy(), ref, frac=1e-2)


def test_causal_attention_is_causal():
    """Changing the keys and values of later rows leaves earlier rows'
    context unchanged."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((B * S, 3 * E)).astype(np.float32)).bfloat16()
    base = tbk.causal_attention(qkv, S, H).reshape(B, S, E)
    qkv2 = qkv.clone().reshape(B, S, 3 * E)
    qkv2[:, 40:, E:] = torch.randn(B, S - 40, 2 * E).bfloat16()
    out = tbk.causal_attention(qkv2.reshape(B * S, 3 * E), S, H).reshape(B, S, E)
    assert torch.equal(out[:, :40], base[:, :40])
    assert not torch.equal(out[:, 40:], base[:, 40:])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_halves_match_jax(seed, layer):
    """One text layer: K6a, then K6b, vs ``_halves_block``'s bf16
    branch (``_attn_half_kernel``, ``_mlp_half_kernel``)."""
    jp = _params(seed)
    x = _rows(seed)
    lp = jax.tree_util.tree_map(lambda a: a[layer], jp["text"]["blocks"])
    kw = dict(s_real=S, use_mask=True, s_pad=S_PAD)
    ref_mid = jbk._halves_block(_pad(x), lp, H, _bias(), None, True, mlp_half=False, **kw)
    ref_out = jbk._halves_block(_pad(x), lp, H, _bias(), None, True, **kw)
    t_layer = layer_slice(tclip.params_from_numpy(jp)["text"]["blocks"], layer)
    mid = tbk.attn_half(x, t_layer, S, H)
    out = tbk.mlp_half(mid, t_layer)
    assert mid.dtype == out.dtype == torch.bfloat16
    _close(mid.float().numpy(), _unpad(ref_mid))
    _close(out.float().numpy(), _unpad(ref_out))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_text_tower_matches_jax(seed):
    jp = _params(seed)
    x = _rows(seed)
    ref = jbk.run_fused_tower(_to_jax(x).reshape(B, S, E), jp["text"]["blocks"], H,
                              causal_mask(S), interpret=True)
    got = tbk.run_float_tower(x, tclip.params_from_numpy(jp)["text"]["blocks"], H, s=S, causal=True)
    assert got.shape == (B * S, E) and got.dtype == torch.bfloat16
    _close(got.float().numpy(), _np(ref).reshape(B * S, E))


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_text_matches_jax(seed):
    jp = _params(seed)
    ids = _ids(seed)
    cfg = jclip.CLIPConfig(**SMALL)
    ref = _np(jclip.encode_text(jp, cfg, jnp.asarray(ids), dtype=jnp.bfloat16, impl="fused"))
    got = tclip.encode_text(tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL), ids,
                            device="cpu", dtype=torch.bfloat16)
    assert got.shape == (B, SMALL["embed_dim"]) and got.dtype == torch.bfloat16
    _close(got.float().numpy(), ref)


_JAX_STRICT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jcf_tpu.models import clip as jclip
d = np.load(sys.argv[1], allow_pickle=True).item()
cfg = jclip.CLIPConfig(**d["cfg"])
out = jclip.encode_text(d["params"], cfg, jnp.asarray(d["ids"]), dtype=jnp.bfloat16, impl="fused")
np.save(sys.argv[2], np.asarray(out.astype(jnp.float32)))
"""


def test_encode_text_strict_bf16(tmp_path):
    """With XLA's excess precision off, both sides round every bf16 cast
    point: the features agree to cos >= 0.9999 per row."""
    jp = _params(3)
    ids = _ids(3, b=6)
    np.save(tmp_path / "in.npy", {"params": jp, "ids": ids, "cfg": SMALL}, allow_pickle=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_STRICT, str(tmp_path / "in.npy"),
                    str(tmp_path / "out.npy")], cwd=ROOT, env=env, check=True, timeout=600)
    ref = np.load(tmp_path / "out.npy")
    got = tclip.encode_text(tclip.params_from_numpy(jp), tclip.CLIPConfig(**SMALL), ids,
                            device="cpu", dtype=torch.bfloat16).float().numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.9999, cos
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
