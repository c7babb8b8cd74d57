"""The arithmetic of the float towers' LayerNorm row kernel
(``csrc/text_block.cu`` ``ln_affine_vec_kernel``) on the CPU.

The kernel runs only on the card. Here its reduction order is emulated in
torch: a lane holds the row's 16-byte chunks c = lane + 32k (8 bf16 or 4
f32 contiguous elements each), sums their f32 values in order (chunk k,
then element), and the warp adds the 32 lane sums by the xor butterfly
(16, 8, 4, 2, 1); mean = sum / E; the same for the squared deviations
(one fused multiply-add an element, emulated in f64 and rounded once);
rstd = rsqrt(var + 1e-5); then ``((x - mean) * rstd) * scale + bias``, one
f32 rounding an operation, cast to the rows' dtype. The emulation is held
against JAX's ``_ln_rows`` (``jcf_tpu/ops/block_kernel.py``, the head of
K6a and K6b) with the scale and bias cast to the rows' dtype, as the
callers cast them, at the bars ``chip_smoke.py`` holds the kernel to: bf16
within 1 ulp + 1e-3, f32 within 1e-5 + 1e-5 |ref|.

Every third row carries a large common offset: mean 100 with std 0.01 in
f32 (values 100 + k / 128 for integers k) and std 1 in bf16 (100 + k / 2:
bf16's spacing at 100 is 0.5, so std 0.01 would round every value to
100). Each offset row's deviations come in pairs k, -k, so its sum is
exactly 100 E in any order and the mean exactly 100; a one-pass variance,
E[x^2] - mean^2, loses the f32 row's variance (1e-4 under 10^4), and the
last test shows that it misses the bar there.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu_torch.ops import block_kernel as tbk

torch.set_num_threads(1)

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def offset_row(rng, e: int, dtype: torch.dtype) -> np.ndarray:
    """One row of mean exactly 100: deviations k / 128 (f32, std ~0.01)
    or k / 2 (bf16, std ~1) in pairs k, -k, shuffled (a trailing 0 for an
    odd width)."""
    step, sd = (1 / 128, 1.28) if dtype == torch.float32 else (1 / 2, 2.0)
    k = np.rint(rng.standard_normal(e // 2) * sd)
    dev = np.concatenate([k, -k, np.zeros(e % 2)])
    return 100.0 + rng.permutation(dev) * step


def ln_inputs(seed: int, m: int, e: int, dtype: torch.dtype):
    """Seeded rows [m, e] (standard normal; every third row, from row 1, an
    ``offset_row``), scale 1 + 0.1 N and bias 0.1 N, all in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, e))
    for i in range(1, m, 3):
        x[i] = offset_row(rng, e, dtype)
    scale = 1 + 0.1 * rng.standard_normal(e)
    bias = 0.1 * rng.standard_normal(e)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dtype) for a in (x, scale, bias))


def lane_layout(e: int, v: int) -> torch.Tensor:
    """[32, n] element index of each lane's values in the kernel's order
    (chunk c = lane + 32 k, then its v elements), -1 past the row."""
    cpl = -(-e // (32 * v))
    lane = torch.arange(32)[:, None, None]
    k = torch.arange(cpl)[None, :, None]
    i = torch.arange(v)[None, None, :]
    idx = ((lane + 32 * k) * v + i).reshape(32, cpl * v)
    return torch.where(idx < e, idx, torch.full_like(idx, -1))


def warp_sum(lanes: torch.Tensor) -> torch.Tensor:
    """[m, 32] f32 lane values -> [m] their sum by the xor butterfly (every
    lane ends with the same value; lane 0's is returned)."""
    ids = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, ids ^ o]
    return lanes[:, 0]


def lane_sums(values: torch.Tensor, idx: torch.Tensor, fma: bool, mean=None) -> torch.Tensor:
    """[m, e] f32 -> [m, 32] each lane's running f32 sum over its values in
    order: the values, or (``fma``) the squared deviations from ``mean``,
    each added by one fused multiply-add (f64 product and sum, one f32
    rounding)."""
    acc = torch.zeros(values.shape[0], 32, dtype=torch.float32)
    for j in range(idx.shape[1]):
        col = idx[:, j]
        live = col >= 0
        val = values[:, col.clamp(min=0)]
        if fma:
            d = val - mean[:, None]
            nxt = (d.double() * d.double() + acc.double()).float()
        else:
            nxt = acc + val
        acc = torch.where(live[None, :], nxt, acc)
    return acc


def ln_rows_vector_order(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         one_pass: bool = False) -> torch.Tensor:
    """The vector kernel's arithmetic on [m, e] rows in x's dtype -> the
    rows' dtype. ``one_pass``: var = E[x^2] - mean^2 instead (the sum of
    squares in the same order), the failure the offset rows catch."""
    m, e = x.shape
    v = 16 // x.element_size()
    idx = lane_layout(e, v)
    x32 = x.float()
    n = torch.tensor(float(e), dtype=torch.float32)
    mean = warp_sum(lane_sums(x32, idx, False)) / n
    if one_pass:
        sq = warp_sum(lane_sums(x32, idx, True, torch.zeros(m))) / n
        var = sq - mean * mean
    else:
        var = warp_sum(lane_sums(x32, idx, True, mean)) / n
    rstd = torch.rsqrt(var + torch.tensor(1e-5, dtype=torch.float32))
    z = (x32 - mean[:, None]) * rstd[:, None]
    return (z * scale.float() + bias.float()).to(x.dtype)


def jax_ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, jdt) -> torch.Tensor:
    """JAX's ``_ln_rows`` with the affine in the rows' dtype, cast to it."""
    j = [jnp.asarray(t.float().numpy()).astype(jdt) for t in (x, scale, bias)]
    y = np.array(jbk._ln_rows(*j).astype(jnp.float32))
    return torch.from_numpy(y).to(x.dtype)


def close(tag: str, got: torch.Tensor, ref: torch.Tensor) -> bool:
    """The kernel's bars: bf16 1 ulp + 1e-3, f32 1e-5 + 1e-5 |ref|."""
    g, r = got.float(), ref.float()
    if tag == "bf16":
        tol = 2.0**-7 * g.abs().maximum(r.abs()) + 1e-3
    else:
        tol = 1e-5 + 1e-5 * r.abs()
    return bool(((g - r).abs() <= tol).all())


@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("e", [512, 768, 192])
def test_vector_order_matches_jax_ln_rows(tag, e):
    """E = 512 and 768 (the instances of their own) and 192 (the general
    instance: lanes past the row hold no chunk) over 40 rows."""
    dtype, jdt = DTYPES[tag]
    x, scale, bias = ln_inputs(e, 40, e, dtype)
    assert bool((x[1::3].float().mean(-1) == 100.0).all())
    got = ln_rows_vector_order(x, scale, bias)
    ref = jax_ln_rows(x, scale, bias, jdt)
    assert close(tag, got, ref)
    assert close(tag, got, tbk.ln_affine_plain(x, scale, bias))
    assert got.dtype == dtype and bool(got.float().isfinite().all())


def test_lane_layout_covers_each_element_once():
    for e, v in ((512, 8), (768, 8), (512, 4), (768, 4), (192, 8), (64, 4), (1024, 4)):
        idx = lane_layout(e, v)
        live = idx[idx >= 0]
        assert torch.equal(live.sort().values, torch.arange(e))
        # a lane's values are whole 16-byte chunks
        assert bool((idx.reshape(32, -1, v)[..., 0] % v == 0).logical_or(
            idx.reshape(32, -1, v)[..., 0] < 0).all())


@pytest.mark.parametrize("e", [512, 768])
def test_one_pass_variance_fails_the_offset_rows(e):
    """The control: the same order with E[x^2] - mean^2 misses the f32 bar
    on the offset rows, and only there."""
    x, scale, bias = ln_inputs(e, 40, e, torch.float32)
    ref = jax_ln_rows(x, scale, bias, jnp.float32)
    bad = ln_rows_vector_order(x, scale, bias, one_pass=True)
    off = torch.zeros(40, dtype=torch.bool)
    off[1::3] = True
    assert not close("f32", bad[off], ref[off])
    assert close("f32", bad[~off], ref[~off])
