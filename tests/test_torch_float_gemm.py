"""The float towers' two GEMMs on the CPU: the tile plans of the wgmma
kernels (``csrc/bf16_gemm.cu``, ``csrc/f32_gemm.cu``), the TF32 split of
the f32 GEMM (``ops.f32_gemm.tf32_split_plain``) and its arithmetic.

Both kernels run only on the card. Here:
- their plans (``gemm_plan``) as pure functions: the blocks of the grid,
  each walking its tiles as the kernel does (block b: tiles b, b + B, ...,
  N-fastest), cover every 128 x 128 output tile exactly once; the bf16
  grid is persistent from K = 2048 on (two blocks an SM), below it one
  block a tile; the f32 grid is persistent at every K (one block an SM);
  at the paths' shapes (the text tower at 512 prompts x 77 tokens,
  the vision tower at 8192 crops x 50, the 3-head and 64-token towers of
  the card's small-tower phase at 1024 crops);
- the split over f32 bit patterns: hi and lo carry at most 10 explicit
  mantissa bits, each is the nearest tf32 with ties away from zero (as
  ``cvt.rna.tf32.f32`` rounds), checked against an independent float64
  rounding, and |x - hi - lo| <= 2^-22 |x| where x - hi is normal;
- the kernel's arithmetic emulated: per k8 step the products a_lo b_hi,
  a_hi b_lo and a_hi b_hi (each exact in f32) added into the stage's
  partial sum rounded toward zero (the tensor cores' adds truncate),
  which joins the tile's sum by an f32 add rounded to nearest once a
  32-deep stage, then each epilogue, held against JAX's ``dot_general`` at
  ``Precision.HIGHEST`` plus the bias and ``_quick_gelu32`` or the
  residual, and against the port's plain versions (f32 FMAs), at the f32
  GEMM's bar on the card: 1e-5 + 1e-5 |ref| + 1e-6 sum_k |a w|; one
  accumulator over K = 3072 misses that bar where the partial holds it.
"""

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu_torch.ops import bf16_gemm as tbg
from jcf_tpu_torch.ops import f32_gemm as tfg
from jcf_tpu_torch.ops import wgmma_gemm as wg
from _tf32_emulation import split_products

torch.set_num_threads(1)

HI = jax.lax.Precision.HIGHEST
SMS = 132  # an H100 SXM's

# (M, K, N) of the float halves' four products (qkv, out-proj, c_fc,
# c_proj) at width E on M rows
def _tower(m, e):
    return [(m, e, 3 * e), (m, e, e), (m, e, 4 * e), (m, 4 * e, e)]


PLAN_SHAPES = (_tower(39_424, 512) + _tower(409_600, 768) + _tower(51_200, 192)
               + _tower(65_536, 128) + [(1, 96, 24), (4097, 3072, 576), (129, 12, 132)])


def _walk(blocks: int, m: int, n: int) -> np.ndarray:
    """The tile indices of every block of the grid, in the kernel's walk
    (csrc/wgmma_gemm.cuh ring_produce: t = blockIdx.x, + gridDim.x, ...)."""
    tiles = -(-m // 128) * -(-n // 128)
    return np.concatenate([np.arange(b, tiles, blocks) for b in range(blocks)])


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
@pytest.mark.parametrize("module", [tbg, tfg], ids=["bf16", "f32"])
def test_plan_covers_every_tile_once(module, m, k, n):
    """Each output tile of 128 x 128 exactly once, and only tiles that
    touch the output; the bf16 grid persistent from K = 2048 on (two
    blocks an SM), else one block a tile; the f32 grid persistent at every
    K (one block an SM)."""
    blocks = tbg.gemm_plan(m, n, k, SMS) if module is tbg else tfg.gemm_plan(m, n, SMS)
    tiles_n = -(-n // 128)
    t = _walk(blocks, m, n)
    origins = sorted(zip((t // tiles_n) * 128, (t % tiles_n) * 128))
    assert origins == [(r, c) for r in range(0, m, 128) for c in range(0, n, 128)]
    n_tiles = len(origins)
    if module is tbg:
        assert blocks == (min(n_tiles, 2 * SMS) if k >= 2048 else n_tiles)
    else:
        assert blocks == min(n_tiles, SMS)


def test_plan_walks_n_fastest():
    """At vision c_proj (409,600 x 3072 -> 768, persistent) the bf16 grid
    holds two blocks on each of the 132 SMs."""
    assert tbg.gemm_plan(409_600, 768, 3072, SMS) == 264


@pytest.mark.parametrize("bn", [128, 256])
def test_tile_count_refuses_overflow(bn):
    """The wrappers' shape limit (``wgmma_gemm.check_shape``): the kernels'
    int arithmetic holds M + 127, K's bytes + 127 and twice the tile count
    (a block's walk t + gridDim.x); one past each limit raises."""
    wg.check_shape(409_600, 3072, 4 * 3072, "GEMM", bn)
    wg.check_shape(2**31 - 128, 8, 2**31 - 128, "GEMM", bn)
    wg.check_shape(2**23 * 128, 2**7 * bn, 16, "GEMM", bn)  # 2^30 tiles
    for m, n, row_bytes in ((2**31 - 127, 8, 16), (128, 8, 2**31 - 127),
                            (2**23 * 128, 2**7 * bn + 1, 16)):
        with pytest.raises(ValueError):
            wg.check_shape(m, n, row_bytes, "GEMM", bn)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _rna_ref(x: np.ndarray) -> np.ndarray:
    """The nearest tf32 (10 explicit mantissa bits) of each f32 value, ties
    away from zero, from float64 distances to the two neighbours: the
    value with its 13 low bits cleared and the next tf32 away from zero."""
    bits = x.view(np.uint32)
    down = (bits & np.uint32(0xFFFFE000)).view(np.float32)
    up = (bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)
    up = up.view(np.float32)
    d_down = np.abs(x.astype(np.float64) - down.astype(np.float64))
    d_up = np.abs(up.astype(np.float64) - x.astype(np.float64))
    return np.where(d_up <= d_down, up, down)


def _check_split(x: np.ndarray):
    hi, lo = tfg.tf32_split_plain(torch.from_numpy(x)).numpy()
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.array_equal(hi.view(np.uint32), _rna_ref(x).view(np.uint32))
    rem = (x.astype(np.float64) - hi.astype(np.float64)).astype(np.float32)
    assert np.array_equal(rem.astype(np.float64), x.astype(np.float64) - hi.astype(np.float64))
    assert np.array_equal(lo.view(np.uint32), _rna_ref(rem).view(np.uint32))
    normal = np.abs(x) >= np.float32(2.0**-100)
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err[normal] <= 2.0**-22 * np.abs(x[normal].astype(np.float64))).all()


# finite magnitudes whose nearest tf32 is finite (past 0x7F7FEFFF a value
# rounds to infinity), either sign
_BITS = st.tuples(st.integers(0, 0x7F7FEFFF), st.booleans()).map(
    lambda t: t[0] | (0x80000000 if t[1] else 0))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(_BITS, min_size=1, max_size=64))
@example([0x00000000, 0x80000000])                          # zeros
@example([0x00000001, 0x00001000, 0x80001FFF, 0x007FFFFF])  # subnormals, a tie among them
@example([0x3F800000, 0x00800000, 0x7F000000, 0xC0000000])  # powers of two
@example([0x3F801000, 0xBF803000, 0x3F802FFF, 0x3F801001])  # ties up and down, near ties
def test_tf32_split_plain_rounds_to_nearest_ties_away(bits):
    _check_split(_f32(bits))


def test_tf32_split_plain_over_binades():
    """Every binade of normal values, many mantissas each: 10-bit parts,
    round to nearest with ties away, the remainder bound."""
    rng = np.random.default_rng(0)
    exps = np.repeat(np.arange(1, 255, dtype=np.uint32), 64)
    mant = rng.integers(0, 2**23, exps.size, dtype=np.uint32)
    mant[::8] = (mant[::8] & 0x7FE000) | 0x1000  # exact ties
    sign = rng.integers(0, 2, exps.size, dtype=np.uint32) << 31
    bits = sign | (exps << 23) | mant
    bits = bits[(bits & 0x7FFFFFFF) <= 0x7F7FEFFF]
    _check_split(_f32(bits))


def test_tf32_split_plain_keeps_shape_and_rounds_past_the_largest_tf32_to_inf():
    w = torch.randn(6, 8, generator=torch.Generator().manual_seed(0))
    split = tfg.tf32_split_plain(w)
    assert split.shape == (2, 6, 8) and split.dtype == torch.float32
    assert torch.equal(tfg.tf32_split(w), split)  # a CPU tensor: the plain version
    hi = tfg.tf32_split_plain(torch.from_numpy(_f32([0x7F7FF000])))[0]
    assert bool(torch.isinf(hi).all())


# ---------------------------------------------------------------------------
# the split arithmetic, emulated
# ---------------------------------------------------------------------------


def _close_sum(got, ref, a, w):
    tol = 1e-5 + 1e-5 * np.abs(ref) + 1e-6 * (np.abs(a) @ np.abs(w).T)
    assert np.isfinite(got).all()
    bad = np.abs(got - ref) > tol
    assert not bad.any(), f"{int(bad.sum())} over the bar, max {np.abs(got - ref).max():.3e}"


@pytest.mark.parametrize("k", [12, 96, 128, 192, 512, 768, 2048, 3072])
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_split_arithmetic_matches_jax_highest_and_plain(epilogue, k):
    """The emulated split products with each epilogue against JAX's HIGHEST
    dot + bias (+ ``_quick_gelu32`` / + the residual) and against the
    port's plain version, at the f32 GEMM's bar."""
    rng = np.random.default_rng(1000 + k)
    m, n = 40, 72
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    resid = rng.standard_normal((m, n)).astype(np.float32)
    acc = split_products(torch.from_numpy(a), torch.from_numpy(w))
    h = acc + torch.from_numpy(bias)
    got = {"bias": h, "gelu": tbg.gelu_plain(h), "residual": torch.from_numpy(resid) + h}[epilogue]
    dot = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(w), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32, precision=HI) + bias
    ref = {"bias": dot, "gelu": jbk._quick_gelu32(dot), "residual": resid + dot}[epilogue]
    _close_sum(got.numpy(), np.asarray(ref), a, w)
    args = (torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(bias))
    args += (torch.from_numpy(resid),) if epilogue == "residual" else ()
    plain = getattr(tfg, f"f32_gemm_{epilogue}_plain")(*args)
    _close_sum(got.numpy(), plain.numpy(), a, w)
    assert torch.equal(getattr(tfg, f"f32_gemm_{epilogue}")(*args), plain)


def test_split_products_are_closer_than_one_tf32_pass():
    """The three passes recover f32: a single TF32 product (hi x hi) misses
    the bar at K = 768 where the split holds it."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((32, 768)).astype(np.float32)
    w = (rng.standard_normal((48, 768)) / np.sqrt(768)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64).T
    three = split_products(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    one = (tfg.tf32_split_plain(torch.from_numpy(a))[0] @ tfg.tf32_split_plain(
        torch.from_numpy(w))[0].T).numpy()
    tol = 1e-5 + 1e-5 * np.abs(ref) + 1e-6 * (np.abs(a) @ np.abs(w).T)
    assert (np.abs(three - ref) <= tol).all()
    assert (np.abs(one - ref) > tol).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_one_accumulator_misses_the_bar_where_the_partial_holds_it(seed):
    """Why the kernel folds a fresh partial in once a 32-deep stage: with
    the tensor cores' truncating adds, one accumulator over K = 3072 (1152
    adds) drifts past the f32 bar, while the per-stage partial holds it
    with room to spare."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((40, 3072)).astype(np.float32)
    w = (rng.standard_normal((72, 3072)) / np.sqrt(3072)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64).T
    tol = 1e-5 + 1e-5 * np.abs(ref) + 1e-6 * (np.abs(a) @ np.abs(w).T)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    staged = np.abs(split_products(ta, tw).numpy() - ref) / tol
    single = np.abs(split_products(ta, tw, depth=None).numpy() - ref) / tol
    assert staged.max() < 0.1
    assert (single > 1).sum() >= 20


def test_ab_engines_runs_as_a_file_on_the_cpu():
    """The engines' A/B script as the card runs it (a file, the checkout's
    root as ROOT), at 2 images x 8 views of a 1-layer tower on the CPU:
    the device line, the package, then one line an engine with its ms,
    img/s and the SHA-256 of its modes."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(root / "jcf_tpu_torch" / "scripts" / "ab_engines.py"),
                          str(root), "--device", "cpu", "--batch", "2", "--iters", "1", "--layers",
                          "1"], cwd=root / "tests", env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("device: cpu")
    assert lines[1] == f"package: {root / 'jcf_tpu_torch'}"
    assert [line.split(",")[0] for line in lines[2:]] == [f"{e} engine" for e in ("int8", "f32",
                                                                                  "bf16")]
    assert all("(1 iters), sha256 " in line for line in lines[2:])
