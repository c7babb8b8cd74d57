"""The arithmetic of K2's vector kernel (``csrc/assemble.cu``
``assemble_vec_kernel``) on the CPU, and its route choice.

The kernel runs only on the card. Here its order is emulated in torch: a
lane owns chunks of 8 contiguous elements c = lane + 32k of a token row;
per element the epilogue ``acc * col_scale + col_bias`` (a product and a
sum, each rounded to f32), a bf16 cast, the positional add (an f32 sum
rounded to bf16); then ``test_torch_ln_rows``'s lane model for the
LayerNorm statistics (a lane sums its chunks' values in order, the warp
adds the 32 lane sums by the xor butterfly; the same for the squared
deviations, one fused multiply-add an element), ``((y - mean) * rstd) *
ln_scale + ln_bias`` with one f32 rounding an operation, and a bf16
output; row 0 of each crop is the CLS row. The card's ``rsqrtf`` is not
torch's ``rsqrt`` (it may differ by 2 ulp); the bar absorbs that.

The emulation is held against JAX's ``_assemble_kernel`` in interpret
mode (``assemble_dense_rows(..., interpret=True)``, in a subprocess with
XLA's excess precision off, as ``tests/test_torch_assemble.py`` runs it)
and against the port's plain version at the bar the card holds the
kernel to (``tests/test_torch_gpu.py`` ``_bf16_close``): 2^-7 of the
larger magnitude (one bf16 ulp) + 1e-3, at E = 768 (the instance of its
own) and 512 (the general instance), two seeds each. The 1e-3 is for
outputs near 0, where ``z * ln_scale + ln_bias`` cancels: there a last-bit
change of z moves the bf16 output by more than its own ulp (the plain
version and JAX differ so too). Every third token row is an offset row
of mean exactly 100 built as ``test_torch_ln_rows.offset_row`` builds its
bf16 rows (deviations k / 2 in pairs k, -k): the column scales are powers
of two and the biases and positional rows multiples of 1/2, so the
accumulators can be chosen to land every LN input on 100 + k / 2
exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch

import test_torch_ln_rows as lr
from jcf_tpu_torch.ops import assemble_kernel as ta
from test_torch_assemble import _JAX_SIDE, ROOT

torch.set_num_threads(1)

GRID = 7  # ViT-B/32's 7 x 7 patches: 49 token rows and the CLS row a crop
CASES = [(0, 768, 6), (1, 768, 4), (0, 512, 5), (1, 512, 3)]  # (seed, E, crops)


def inputs(seed: int, e: int, b: int):
    """Seeded K2 inputs with offset rows -> (conv [b, 7, 7, e] int32,
    col scale, col bias, pos [49, e] as f32 of bf16 values, cls, pos0,
    ln scale, ln bias) as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_tok = GRID * GRID
    shift = rng.integers(1, 5, e)  # col scale 2^-shift
    scale = np.ldexp(1.0, -shift).astype(np.float32)
    bias = (rng.integers(-8, 9, e) / 2).astype(np.float32)
    pos = (rng.integers(-8, 9, (n_tok, e)) / 2).astype(np.float32)
    acc = rng.integers(-20000, 20000, (b * n_tok, e))
    for r in range(1, b * n_tok, 3):
        k2 = (lr.offset_row(rng, e, torch.bfloat16) - 100) * 2  # k: y = 100 + k / 2
        # acc * 2^-s + m / 2 + n / 2 = 100 + k / 2
        acc[r] = np.rint((200 + k2 - 2 * bias - 2 * pos[r % n_tok]) * np.ldexp(1.0, shift - 1))
    conv = acc.astype(np.int32).reshape(b, GRID, GRID, e)
    cls = rng.standard_normal(e).astype(np.float32)
    pos0 = rng.standard_normal(e).astype(np.float32)
    lns = (1 + 0.1 * rng.standard_normal(e)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(e)).astype(np.float32)
    return conv, scale, bias, pos, cls, pos0, lns, lnb


def cls_row(cls, pos0, lns, lnb) -> torch.Tensor:
    return ta.make_cls_row(*(torch.from_numpy(a) for a in (cls, pos0, lns, lnb)))


def ln_input(conv, scale, bias, pos) -> torch.Tensor:
    """The LN input of every token row in f32: bf16(bf16(acc * scale +
    bias) + pos), the kernel's cast points."""
    b, _, _, e = conv.shape
    a = torch.from_numpy(conv).reshape(-1, e).float()
    t = a * torch.from_numpy(scale) + torch.from_numpy(bias)
    p = torch.from_numpy(pos).bfloat16().float().repeat(b, 1)
    return (t.bfloat16().float() + p).bfloat16().float()


def vector_order(conv, scale, bias, pos, cls, lns, lnb) -> torch.Tensor:
    """The vector kernel's arithmetic -> [b * 50, e] bf16 rows."""
    b, _, _, e = conv.shape
    y = ln_input(conv, scale, bias, pos)
    idx = lr.lane_layout(e, 8)
    n = torch.tensor(float(e), dtype=torch.float32)
    mean = lr.warp_sum(lr.lane_sums(y, idx, False)) / n
    var = lr.warp_sum(lr.lane_sums(y, idx, True, mean)) / n
    rstd = torch.rsqrt(var + torch.tensor(1e-5, dtype=torch.float32))
    z = (y - mean[:, None]) * rstd[:, None]
    rows = (z * torch.from_numpy(lns) + torch.from_numpy(lnb)).bfloat16()
    rows = rows.reshape(b, GRID * GRID, e)
    out = torch.cat([cls.bfloat16().expand(b, 1, e), rows], dim=1)
    return out.reshape(b * (GRID * GRID + 1), e)


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """JAX interpret-mode rows for every case, from one subprocess."""
    tmp = tmp_path_factory.mktemp("assemble_rows")
    arrays = {}
    for seed, e, b in CASES:
        conv, scale, bias, pos, cls, pos0, lns, lnb = inputs(seed, e, b)
        cls_np = cls_row(cls, pos0, lns, lnb).float().numpy()
        for i, a in enumerate((conv, scale, bias, pos, cls_np, lns, lnb)):
            arrays[f"{seed}-{e}:{i}"] = a
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   cwd=ROOT, env=env, check=True, timeout=300)
    return dict(np.load(tmp / "out.npz"))


def bf16_close(got: np.ndarray, ref: np.ndarray) -> bool:
    """``_bf16_close``: within 2^-7 of the larger magnitude + 1e-3."""
    return bool((np.abs(got - ref) <= 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3).all())


@pytest.mark.parametrize("seed,e,b", CASES)
def test_vector_order_matches_jax_and_plain(jax_rows, seed, e, b):
    conv, scale, bias, pos, cls, pos0, lns, lnb = inputs(seed, e, b)
    y = ln_input(conv, scale, bias, pos)
    off = y[1::3]
    k = (off - 100) * 2
    assert bool((off.mean(-1) == 100.0).all()) and bool((k == k.round()).all())
    assert float(y[0::3].std(-1).min()) > 100  # the other rows: large spread
    crow = cls_row(cls, pos0, lns, lnb)
    got = vector_order(conv, scale, bias, pos, crow, lns, lnb)
    assert got.shape == (b * 50, e) and got.dtype == torch.bfloat16
    assert torch.equal(got[::50], crow.expand(b, e))
    g = got.float().numpy()
    assert bf16_close(g, jax_rows[f"{seed}-{e}"])
    plain = ta.assemble_dense_rows(*(torch.from_numpy(a) for a in (conv, scale, bias, pos)), crow,
                                   torch.from_numpy(lns), torch.from_numpy(lnb))
    assert bf16_close(g, plain.float().numpy())


@pytest.mark.parametrize("e", [768, 512, 8, 1024, 192, 136])
def test_route_takes_the_vector_kernel_at_widths_of_eight(e):
    assert ta.assemble_route(e, True) == "vector"
    assert ta.assemble_route(e, False) == "scalar"


@pytest.mark.parametrize("e", [1, 4, 12, 130, 1020])
def test_route_takes_the_scalar_kernel_off_widths_of_eight(e):
    assert ta.assemble_route(e, True) == "scalar"


@pytest.mark.parametrize("e", [0, 1025, 2048])
def test_route_refuses_past_the_widest_row(e):
    with pytest.raises(ValueError):
        ta.assemble_route(e, True)
