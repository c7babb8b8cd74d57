"""The dynamic int8 row quantization of f32 rows (``csrc/block.cu``:
``quant_rows_vec_kernel`` and the scalar ``quant_rows_kernel``; the
wrapper ``ops.block_kernel.quant_rows``) on the CPU.

The kernels run only on the card. Here the route choice is checked as the
pure function the wrapper calls (``quant_rows_route``), and the vector
kernel's order is emulated in torch: a thread of a row group of G warps
(G = 1 up to 1024 columns, 4 past it) holds the row's float4 chunks c = t
+ 32 G k; each element is QuickGELU'd (``h * (0.5 + 0.5 tanh(0.851
h))``, one f32 rounding an operation) or taken as it is; a thread takes
the max of |g| over its chunks, the warp by the xor butterfly, the group
over its warps in order; amax = max(that, 1e-8); q = clip(round(g * (127
/ amax))) and the scale amax * f32(1/127). A max is exact, so the order
cannot move a bit: the emulation equals the plain version bit for bit,
and both are held against JAX's ``_quant_rows`` (after ``_quick_gelu32``
for the hidden) at the bars ``chip_smoke.py`` holds the kernel to: int8
within 1 on at most 1e-3 of the elements (torch's and XLA's tanh differ
in a last bit), scales within 1e-6 relative.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu_torch.ops import block_kernel as tbk

torch.set_num_threads(1)

ROWS = 24


@pytest.mark.parametrize("n", [768, 3072, 512, 2048, 192, 72, 4, 1024, 4096])
def test_route_takes_the_vector_kernel_at_widths_of_four(n):
    assert tbk.quant_rows_route(n, torch.float32, True) == "vector"
    assert tbk.quant_rows_route(n, torch.float32, False) == "scalar"


@pytest.mark.parametrize("n", [130, 1, 3, 767, 4095])
def test_route_takes_the_scalar_kernel_off_widths_of_four(n):
    assert tbk.quant_rows_route(n, torch.float32, True) == "scalar"
    assert tbk.quant_rows_route(n, torch.float32, False) == "scalar"


@pytest.mark.parametrize("n,dtype", [(4097, torch.float32), (8192, torch.float32),
                                     (0, torch.float32), (768, torch.bfloat16),
                                     (768, torch.float16), (3072, torch.float64)])
def test_route_refuses(n, dtype):
    with pytest.raises(ValueError):
        tbk.quant_rows_route(n, dtype, True)


def group_warps(n: int) -> int:
    """The warps of the vector kernel's row group at width ``n``."""
    return 1 if n <= 1024 else 4


def vector_order(x: torch.Tensor, gelu: bool):
    """The vector kernel's arithmetic on f32 rows [m, n], n a multiple of
    4 -> (int8 [m, n], f32 scales [m])."""
    m, n = x.shape
    g = tbk.gelu_plain(x) if gelu else x
    warps = group_warps(n)
    threads, chunks = 32 * warps, n // 4
    cpl = -(-chunks // threads)
    c = torch.arange(threads)[:, None, None] + threads * torch.arange(cpl)[None, :, None]
    thread_idx = (4 * c + torch.arange(4)[None, None, :]).reshape(threads, 4 * cpl)
    thread_idx = torch.where(thread_idx < n, thread_idx, torch.full_like(thread_idx, -1))
    a = g.abs()
    per_thread = torch.zeros(m, threads)
    for j in range(thread_idx.shape[1]):
        col = thread_idx[:, j]
        live = col >= 0
        val = a[:, col.clamp(min=0)]
        per_thread = torch.where(live[None, :], torch.maximum(per_thread, val), per_thread)
    lanes = per_thread.reshape(m, warps, 32)
    ids = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = torch.maximum(lanes, lanes[..., ids ^ o])
    amax = lanes[..., 0][:, 0]
    for w in range(1, warps):
        amax = torch.maximum(amax, lanes[..., 0][:, w])
    amax = torch.clamp_min(amax, 1e-8)
    inv = torch.full_like(amax, 127.0) / amax
    q = torch.clamp(torch.round(g * inv[:, None]), -127, 127).to(torch.int8)
    return q, amax * torch.tensor(1.0 / 127.0, dtype=torch.float32)


def jax_quant_rows(x: torch.Tensor, gelu: bool):
    """JAX's ``_quant_rows`` (after ``_quick_gelu32``) -> (int8, f32 scales)."""
    h = jnp.asarray(x.numpy())
    q, sc = jbk._quant_rows(jbk._quick_gelu32(h) if gelu else h)
    return torch.from_numpy(np.array(q)), torch.from_numpy(np.array(sc)).reshape(-1)


def inputs(n: int, seed: int) -> torch.Tensor:
    """Seeded f32 rows [ROWS, n]: normal x 3 (the c_fc output's scale), an
    all-zero row, a row of one large value, a row of exact ties at the
    largest value and a row of -0.0 but for one value near the f32
    maximum."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, n)).astype(np.float32) * 3
    x[1] = 0.0
    x[2] = 1e-3 * x[2]
    x[2, n // 2] = 40.0
    x[3] = np.float32(-2.5)
    x[3, ::2] = 2.5
    x[4, :] = -0.0
    x[4, 0] = 3e38 if n > 1 else 1.0
    return torch.from_numpy(x)


def int8_bar(got, ref) -> bool:
    (q, sc), (q_ref, sc_ref) = got, ref
    d = (q.int() - q_ref.int()).abs()
    return (int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
            and bool(((sc - sc_ref).abs() <= 1e-6 * sc_ref.abs()).all()))


@pytest.mark.parametrize("gelu", [False, True], ids=["ctx", "gelu"])
@pytest.mark.parametrize("n", [768, 3072, 512, 2048, 192, 72])
@pytest.mark.parametrize("seed", [0, 1])
def test_vector_order_equals_plain_and_matches_jax(gelu, n, seed):
    """The vector instances' order at the paths' widths (ViT-B/32's
    context and hidden, the text tower's, the 3-head tower's, an odd
    one): bit for bit the plain version, within the bar of JAX."""
    x = inputs(n, seed)
    got = vector_order(x, gelu)
    plain = (tbk.gelu_quant_rows_plain if gelu else tbk.quant_rows_plain)(x)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert int8_bar(got, jax_quant_rows(x, gelu))
    assert got[0].dtype == torch.int8 and got[1].shape == (ROWS,)
    assert int(got[0][1].abs().max()) == 0 and float(got[1][1]) == np.float32(1e-8) * np.float32(1 / 127)


@pytest.mark.parametrize("gelu", [False, True], ids=["ctx", "gelu"])
def test_scalar_width_plain_matches_jax(gelu):
    """A width off the vector kernel (130: the scalar route) keeps the
    same function."""
    x = inputs(130, 2)
    assert int8_bar((tbk.gelu_quant_rows_plain if gelu else tbk.quant_rows_plain)(x),
                    jax_quant_rows(x, gelu))
