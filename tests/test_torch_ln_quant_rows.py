"""The arithmetic of the int8 towers' LayerNorm + quant row kernel
(``csrc/block.cu``: ``ln_quant_vec_kernel`` at widths 512 and 768,
``ln_quant_kernel`` at others) on the CPU.

The kernels run only on the card. Here their reduction order is emulated
in torch with ``test_torch_ln_rows``'s lane model: the vector kernel's
lane holds the row's 16-byte chunks c = lane + 32k (8 bf16 or 4 f32
contiguous elements), the scalar kernel's the elements j = lane + 32k
(chunks of one element); a lane sums its values in order, the warp adds
the 32 lane sums by the xor butterfly; mean = sum / E; the same for the
squared deviations (one fused multiply-add an element); rstd = rsqrt(var +
1e-5); z = (x - mean) * rstd, with the unfolded tree's f32 affine z * g +
b, one f32 rounding an operation; then the int8 values round(y * inv)
clipped to +-127, with the calibrated ``inv`` or the row's own 127 /
max(max |y|, 1e-8) and the scale amax * f32(1/127).

The emulation of each instance (static, dynamic, the LN affine on bf16
and on f32 rows) is held against JAX's composition
(``jcf_tpu/ops/block_kernel.py``: ``_ln_norm`` + ``_quant_rows_static``,
``_ln_norm`` + ``_quant_rows``, ``_ln_rows`` + ``_quant_rows``) and
against the port's plain versions at the bars ``chip_smoke.py`` holds the
kernel to: int8 within 1 on at most 1e-3 of the elements, scales within
1e-6 relative. Every third row is an offset row of mean exactly 100
(``test_torch_ln_rows.offset_row``); the last test shows that a one-pass
variance misses the bar there. An offset row's deviations are k steps
for integers k, so its z-norm is k times one number, and a dynamic scale
maps k to 127 k / k_max: for an even k_max the values at k = k_max / 2
are exact rounding ties in real arithmetic, which any f32 order (JAX's,
the plain version's, the kernel's) sends either way by a last-bit
difference. The largest pair is therefore made odd (k_max + 1 steps), so
no value of these rows sits on a tie and the bar measures the order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
import test_torch_ln_rows as lr
from jcf_tpu_torch.ops import block_kernel as tbk

torch.set_num_threads(1)

ROWS = 40
STATIC_INV = 127.0 / 4.5
KINDS = ("static", "dynamic", "affine")


def ln_quant_order(x: torch.Tensor, kind: str, g=None, b=None, v=None, one_pass=False):
    """The kernel's arithmetic on [m, e] rows in x's dtype with ``v``
    elements a lane chunk (default: a 16-byte chunk, the vector kernel;
    1: the scalar kernel) -> (int8 [m, e], f32 scales [m] or None).
    ``one_pass``: var = E[x^2] - mean^2 instead."""
    m, e = x.shape
    idx = lr.lane_layout(e, v or 16 // x.element_size())
    x32 = x.float()
    n = torch.tensor(float(e), dtype=torch.float32)
    mean = lr.warp_sum(lr.lane_sums(x32, idx, False)) / n
    if one_pass:
        var = lr.warp_sum(lr.lane_sums(x32, idx, True, torch.zeros(m))) / n - mean * mean
    else:
        var = lr.warp_sum(lr.lane_sums(x32, idx, True, mean)) / n
    rstd = torch.rsqrt(var + torch.tensor(1e-5, dtype=torch.float32))
    y = (x32 - mean[:, None]) * rstd[:, None]
    if kind == "affine":
        y = y * g + b
    if kind == "static":
        inv = torch.tensor(STATIC_INV, dtype=torch.float32)
        return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8), None
    amax = torch.clamp_min(y.abs().amax(dim=-1), 1e-8)
    inv = torch.full_like(amax, 127.0) / amax
    q = torch.clamp(torch.round(y * inv[:, None]), -127, 127).to(torch.int8)
    return q, amax * torch.tensor(1.0 / 127.0, dtype=torch.float32)


def jax_ln_quant(x: torch.Tensor, kind: str, g=None, b=None):
    """JAX's composition of the instance -> (int8, f32 scales or None)."""
    jdt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    if kind == "static":
        q = jbk._quant_rows_static(jbk._ln_norm(jx), jnp.float32(STATIC_INV))
        return torch.from_numpy(np.array(q)), None
    if kind == "dynamic":
        y = jbk._ln_norm(jx)
    else:
        y = jbk._ln_rows(jx, jnp.asarray(g.numpy()), jnp.asarray(b.numpy()))
    q, sc = jbk._quant_rows(y)
    return torch.from_numpy(np.array(q)), torch.from_numpy(np.array(sc)).reshape(-1)


def plain_ln_quant(x: torch.Tensor, kind: str, g=None, b=None):
    """The port's plain version of the instance."""
    if kind == "static":
        return tbk.ln_quant_plain(x, torch.tensor([[STATIC_INV]])), None
    if kind == "dynamic":
        return tbk.ln_quant_rows_plain(x)
    return tbk.ln_affine_quant_rows_plain(x, g, b)


def inputs(e: int, dtype: torch.dtype):
    """Seeded rows (``test_torch_ln_rows.ln_inputs``: offset rows from row
    1, every third, their largest deviation an odd number of steps) and the
    f32 affine: rounded to bf16 for bf16 rows, as the callers round the
    unfolded tree's LN params there."""
    x, scale, bias = lr.ln_inputs(e, ROWS, e, dtype)
    step = 1 / 128 if dtype == torch.float32 else 1 / 2
    for i in range(1, ROWS, 3):
        k = torch.round((x[i].double() - 100) / step)
        k_max = float(k.abs().max())
        if k_max % 2 == 0:
            for sign in (1, -1):
                j = int((k == sign * k_max).nonzero()[0])
                x[i, j] = 100 + sign * (k_max + 1) * step
    return x, scale.float(), bias.float()


def int8_bar(got, ref) -> bool:
    (q, sc), (q_ref, sc_ref) = got, ref
    d = (q.int() - q_ref.int()).abs()
    ok = int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    if sc_ref is not None:
        ok = ok and bool(((sc - sc_ref).abs() <= 1e-6 * sc_ref.abs()).all())
    return ok


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tag", list(lr.DTYPES))
@pytest.mark.parametrize("e", [512, 768])
def test_vector_order_matches_jax(kind, tag, e):
    """The vector instances (E = 512 and 768) over 40 rows."""
    dtype = lr.DTYPES[tag][0]
    x, g, b = inputs(e, dtype)
    assert bool((x[1::3].float().mean(-1) == 100.0).all())
    k_max = ((x[1::3].double() - 100).abs().amax(-1) / (0.5 if tag == "bf16" else 1 / 128))
    assert bool((k_max % 2 == 1).all())
    got = ln_quant_order(x, kind, g, b)
    assert int8_bar(got, jax_ln_quant(x, kind, g, b))
    assert int8_bar(got, plain_ln_quant(x, kind, g, b))
    assert got[0].dtype == torch.int8 and (got[1] is None) == (kind == "static")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tag", list(lr.DTYPES))
@pytest.mark.parametrize("e", [192, 128])
def test_scalar_order_matches_jax(kind, tag, e):
    """The scalar kernel's order (element j = lane + 32k) at the widths
    of the 3-head and 64-token towers, which take it."""
    dtype = lr.DTYPES[tag][0]
    x, g, b = inputs(e, dtype)
    got = ln_quant_order(x, kind, g, b, v=1)
    assert int8_bar(got, jax_ln_quant(x, kind, g, b))
    assert int8_bar(got, plain_ln_quant(x, kind, g, b))


def test_vector_widths_are_the_kernels():
    """The widths the emulation calls vector are those the wrapper sends
    to the vector kernel; at each a lane holds whole chunks."""
    assert tbk.LN_QUANT_VEC_WIDTHS == (512, 768)
    for e in tbk.LN_QUANT_VEC_WIDTHS:
        for v in (8, 4):
            assert e % (32 * v) == 0


@pytest.mark.parametrize("kind", ["dynamic", "affine"])
@pytest.mark.parametrize("e", [512, 768])
def test_one_pass_variance_fails_the_offset_rows(kind, e):
    """The control: the same order with E[x^2] - mean^2 on f32 rows misses
    the int8 bar on the offset rows, and only there."""
    x, g, b = inputs(e, torch.float32)
    ref = jax_ln_quant(x, kind, g, b)
    bad = ln_quant_order(x, kind, g, b, one_pass=True)
    off = torch.zeros(ROWS, dtype=torch.bool)
    off[1::3] = True

    def rows(t, sel):
        return tuple(None if a is None else a[sel] for a in t)

    assert not int8_bar(rows(bad, off), rows(ref, off))
    assert int8_bar(rows(bad, ~off), rows(ref, ~off))
