"""The port's probe scripts (``jcf_tpu_torch/scripts``) on the CPU against
the TPU probes in ``scripts/``:

- P4 (``exp_boundary_cost``): the TPU probe's ``copy_kernel`` through
  ``pl.pallas_call`` in interpret mode, with the script's BlockSpecs
  (tiles of 800 rows, VMEM) at [1600, 768], chained 3 times, against the
  port's plain chain of ``copy_add_one``: bit for bit.
- P5 (``profile_halves``): JAX's ``_attn_half_int8_kernel`` and
  ``_mlp_half_int8_kernel`` in interpret mode on the TPU layout (50 real
  rows a crop padded to 56), unfolded and dynamic, against the port's
  halves on the 50 real rows at width 128 (2 heads of 64). The kernels
  mask keys 50-55 as the serving tower does (``use_mask=False``: zeroed
  pad K/V rows and a sum selector, the route the port's attention ports);
  the additive-bias route that ``scripts/profile_halves.py`` left at its
  default normalizes the probabilities before PV, as the text tower does,
  and so rounds otherwise on about 2% of the elements. Bars of
  ``tests/test_torch_masked_int8.py``: bf16 rows within 1 bf16 ulp + 1e-3
  on all but 2% of the elements (an int8 tie moved), everywhere within
  0.05 + 0.05 |ref| at row cos >= 0.999.
- Both scripts' ``main`` at a small size on the CPU.
"""

import contextlib
import functools
import importlib.util
import io
import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu.models import clip as jclip
from jcf_tpu.ops import quant as jquant
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops import quant as tquant
from jcf_tpu_torch.ops.layers import layer_slice
from jcf_tpu_torch.scripts import exp_boundary_cost as p4
from jcf_tpu_torch.scripts import profile_halves as p5

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tpu_probe(name: str):
    spec = importlib.util.spec_from_file_location(f"tpu_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# P4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_copy_chain_equals_the_tpu_probe(seed):
    tpu = _tpu_probe("exp_boundary_cost")
    rows, e, tile = 1600, 768, 800
    spec = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    one = pl.pallas_call(tpu.copy_kernel, grid=(rows // tile,),
                         in_specs=[spec((tile, e), lambda i: (i, 0))],
                         out_specs=spec((tile, e), lambda i: (i, 0)),
                         out_shape=jax.ShapeDtypeStruct((rows, e), jnp.bfloat16),
                         interpret=True)
    x = np.random.default_rng(seed).standard_normal((rows, e)).astype(np.float32) * 300
    ref = jnp.asarray(x, jnp.bfloat16)
    for _ in range(3):
        ref = one(ref)
    got = p4.chain(torch.from_numpy(x).to(torch.bfloat16), 3)
    assert p4.LAUNCHES["copy_add_one"] == 0  # the CPU runs the plain version
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))


def test_boundary_fit_recovers_a_line():
    slope, intercept = p4.fit([6, 12, 24, 48], [0.5 + 0.25 * n for n in (6, 12, 24, 48)])
    assert abs(slope - 0.25) < 1e-12 and abs(intercept - 0.5) < 1e-12


def test_boundary_main_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert p4.main(["--device", "cpu", "--rows", "16", "--width", "32", "--iters", "1",
                        "--lengths", "2,4"]) == 0
    text = out.getvalue()
    assert text.splitlines()[0].startswith("device: cpu")
    assert "n=  2: eager" in text and "n=  4: eager" in text
    assert "H100 memory bound per kernel" in text and "eager: slope" in text
    assert "graph: not measured (no card)" in text


# ---------------------------------------------------------------------------
# P5
# ---------------------------------------------------------------------------

E, HEADS, S_REAL, S_PAD, CROPS, GROUP = 128, 2, 50, 56, 4, 2


@functools.lru_cache(maxsize=None)
def _params():
    """JAX params (numpy) of a 1-layer ViT at width 128, 224² / 32 (50
    tokens), with nonzero LN affines and biases."""
    cfg = jclip.CLIPConfig(embed_dim=32, vision_layers=1, vision_width=E, text_width=64,
                           text_heads=1, text_layers=1, vocab_size=64)
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(0, cfg))
    rng = np.random.default_rng(3)
    blocks = jp["visual"]["blocks"]
    for ln in ("ln_1", "ln_2"):
        shape = blocks[ln]["scale"].shape
        blocks[ln]["scale"] = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        blocks[ln]["bias"] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    for leaf in (blocks["attn"], blocks["mlp"]["c_fc"], blocks["mlp"]["c_proj"]):
        for k in [k for k in leaf if k.startswith("b")]:
            leaf[k] = (0.05 * rng.standard_normal(leaf[k].shape)).astype(np.float32)
    return jp


def _tpu_halves(xp, lp, lq):
    """The TPU probe's two pallas_calls (13 and 11 operands), interpret mode,
    on padded bf16 rows [B, 56, E]."""
    vmem = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)

    def full(shape):
        return vmem(shape, lambda i: tuple(0 for _ in shape))

    tile = vmem((GROUP, S_PAD, E), lambda i: (i, 0, 0))
    ones = jnp.ones((1, 1), jnp.float32)
    bias = jnp.full((S_PAD, S_PAD), jbk._NEG_INF, jnp.float32).at[:S_REAL, :S_REAL].set(0.0)
    common = dict(grid=(CROPS // GROUP,), out_specs=tile, interpret=True,
                  out_shape=jax.ShapeDtypeStruct(xp.shape, xp.dtype))
    d = E // HEADS
    a, m = lq["attn"], lq["mlp"]
    attn = pl.pallas_call(
        functools.partial(jbk._attn_half_int8_kernel, n_heads=HEADS, head_dim=d,
                          scale=1.0 / math.sqrt(d), group=GROUP, s_pad=S_PAD, s_real=S_REAL,
                          use_mask=False, folded=False),
        in_specs=[tile, full((E,)), full((E,)), full((1, 1)), full((1, 1)), full((1, 1)),
                  full((3 * E, E)), full((3 * E,)), full((3 * E,)),
                  full((E, E)), full((E,)), full((E,)), full((S_PAD, S_PAD))], **common)
    mid = attn(xp, jnp.asarray(lp["ln_1"]["scale"], xp.dtype),
               jnp.asarray(lp["ln_1"]["bias"], xp.dtype), ones, ones, ones,
               a["w_qkv"].w_int8, a["w_qkv"].w_scale, a["w_qkv"].bias,
               a["w_out"].w_int8, a["w_out"].w_scale, a["w_out"].bias, bias)
    hidden = m["c_fc"].w_int8.shape[0]
    mlp = pl.pallas_call(
        functools.partial(jbk._mlp_half_int8_kernel, group=GROUP, s_pad=S_PAD, folded=False,
                          s_real=S_REAL),
        in_specs=[tile, full((E,)), full((E,)), full((1, 1)), full((1, 1)),
                  full((hidden, E)), full((hidden,)), full((hidden,)),
                  full((E, hidden)), full((E,)), full((E,))], **common)
    out = mlp(mid, jnp.asarray(lp["ln_2"]["scale"], xp.dtype),
              jnp.asarray(lp["ln_2"]["bias"], xp.dtype), ones, ones,
              m["c_fc"].w_int8, m["c_fc"].w_scale, m["c_fc"].bias,
              m["c_proj"].w_int8, m["c_proj"].w_scale, m["c_proj"].bias)
    return mid, out


def _real_rows(a):
    return np.asarray(jnp.asarray(a)[:, :S_REAL].astype(jnp.float32)).reshape(-1, E)


def _close_bf16(got, ref, share=2e-2):
    d = np.abs(got - ref)
    over = (d > 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3).mean()
    assert over <= share, over
    cos = ((got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1)))
    assert cos.min() >= 0.999, cos.min()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unpadded_halves_equal_the_padded_masked_layout(seed):
    jp = _params()
    lp = jax.tree_util.tree_map(lambda a: a[0], jp["visual"]["blocks"])
    lq = jax.tree_util.tree_map(lambda a: a[0], jquant.quantize_clip_params(jp)["visual"])
    tp = tclip.params_from_numpy(jp)
    layer = layer_slice(tquant.quantize_clip_params(tp)["visual"], 0)
    lns = [tbk._layer_ln(tp["visual"]["blocks"], 0, n, torch.bfloat16) for n in ("ln_1", "ln_2")]
    x = np.random.default_rng(seed).standard_normal((CROPS, S_REAL, E)).astype(np.float32)
    x = x.astype(jnp.bfloat16).astype(np.float32)
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 0), (0, S_PAD - S_REAL), (0, 0)))
    mid_ref, out_ref = _tpu_halves(xp, lp, lq)
    rows = torch.from_numpy(x.reshape(-1, E)).to(torch.bfloat16)
    mid = tbk.attn_half_int8(rows, layer["attn"], S_REAL, HEADS, ln=lns[0])
    _close_bf16(mid.float().numpy(), _real_rows(mid_ref))
    mid_j = torch.from_numpy(_real_rows(mid_ref).copy()).to(torch.bfloat16)
    out = tbk.mlp_half_int8(mid_j, layer["mlp"], ln=lns[1])
    _close_bf16(out.float().numpy(), _real_rows(out_ref))


def test_profile_halves_work_counts():
    """ViT-B/32 at b1024 x 50: the GEMMs' int8 operations (2 x rows x E x
    4E for the attention half, 2 x rows x E x 8E for the MLP half) and the
    attention's bf16 products."""
    w = p5.work(1024, 50, 768, 12, 3072)
    rows = 1024 * 50
    assert w["attn"][1] == 2 * rows * 768 * 4 * 768
    assert w["mlp"][1] == 2 * rows * 768 * 8 * 768
    assert w["attn"][2] == 4 * 1024 * 12 * 50 * 50 * 64
    assert p5.bound_ms(*w["mlp"])[1] == "operations"


def test_profile_halves_main_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert p5.main(["--device", "cpu", "--crops", "2", "--width", "128", "--iters", "1"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("device: cpu")
    assert lines[1].startswith("attn half int8 (b2 x 50, E 128)") and "H100 bound" in lines[1]
    assert lines[2].startswith("mlp half int8 (b2 x 50, E 128)")


def test_profile_halves_stages_cover_each_half():
    """The stage wrappers P5 times on the card see every stage of each
    half, in order, and leave ``block_kernel`` as it was."""
    jp = _params()
    tp = tclip.params_from_numpy(jp)
    layer = layer_slice(tquant.quantize_clip_params(tp)["visual"], 0)
    lns = [tbk._layer_ln(tp["visual"]["blocks"], 0, n, torch.bfloat16) for n in ("ln_1", "ln_2")]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2 * S_REAL, E),
                                                                  np.float32)).to(torch.bfloat16)
    before = {name: getattr(tbk, name) for name in p5.STAGES}
    for fn, want in (
            (lambda: tbk.attn_half_int8(x, layer["attn"], S_REAL, HEADS, ln=lns[0]),
             ["ln_affine_quant_rows", "int8_gemm_bf16", "attention", "quant_rows",
              "int8_gemm_residual"]),
            (lambda: tbk.mlp_half_int8(x, layer["mlp"], ln=lns[1]),
             ["ln_affine_quant_rows", "int8_gemm_f32", "quant_rows", "int8_gemm_residual"])):
        seen = []
        p5.staged(fn, lambda name, call: (seen.append(name), call())[1])
        assert seen == want
    assert all(getattr(tbk, name) is f for name, f in before.items())
