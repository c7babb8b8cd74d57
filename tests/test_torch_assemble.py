"""K2, the assembly kernel's plain version, vs the JAX Pallas kernel in
interpret mode: bf16 rows within one bf16 ulp (the LayerNorm statistics
are f32 sums taken in another order), the CLS rows equal.

The reference adds the positional rows in bf16 and feeds the bf16 sum to
the LayerNorm. XLA's CPU compiler by default keeps that sum in f32 (its
``xla_allow_excess_precision``), which the TPU kernel and the port do
not, so the JAX side runs in a subprocess with excess precision off and
the comparison holds the declared cast points."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from jcf_tpu.ops.assemble_kernel import make_cls_row as j_make_cls_row
from jcf_tpu_torch.ops import assemble_kernel as ta

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(0, 6), (1, 5), (2, 16)]  # (seed, crops)

_JAX_SIDE = """
import sys
import numpy as np
import jax.numpy as jnp
from jcf_tpu.ops.assemble_kernel import assemble_dense_rows
d = dict(np.load(sys.argv[1]))
out = {}
for key in sorted({k.split(":")[0] for k in d}):
    a = [d[f"{key}:{i}"] for i in range(7)]
    a[4] = jnp.asarray(a[4]).astype(jnp.bfloat16)
    out[key] = np.asarray(assemble_dense_rows(*map(jnp.asarray, a), interpret=True)
                          .astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), for x != 0."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


def _inputs(seed, b=6, g=4, e=128):
    rng = np.random.default_rng(seed)
    conv = rng.integers(-20000, 20000, (b, g, g, e)).astype(np.int32)
    scale = (rng.random(e) * 1e-4).astype(np.float32)
    bias = rng.standard_normal(e).astype(np.float32)
    pos = (0.5 * rng.standard_normal((g * g, e))).astype(np.float32)
    cls = rng.standard_normal(e).astype(np.float32)
    pos0 = rng.standard_normal(e).astype(np.float32)
    lns = (1 + 0.1 * rng.standard_normal(e)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(e)).astype(np.float32)
    return conv, scale, bias, pos, cls, pos0, lns, lnb


def _cls_row(cls, pos0, lns, lnb):
    return ta.make_cls_row(*(torch.from_numpy(a) for a in (cls, pos0, lns, lnb)))


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """JAX interpret-mode rows for every case, from one subprocess."""
    tmp = tmp_path_factory.mktemp("assemble")
    arrays = {}
    for seed, b in CASES:
        conv, scale, bias, pos, cls, pos0, lns, lnb = _inputs(seed, b=b)
        cls_np = _cls_row(cls, pos0, lns, lnb).float().numpy()
        for i, a in enumerate((conv, scale, bias, pos, cls_np, lns, lnb)):
            arrays[f"{seed}-{b}:{i}"] = a
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   cwd=ROOT, env=env, check=True, timeout=300)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cls_row_matches_jax(seed):
    *_, cls, pos0, lns, lnb = _inputs(seed)
    # the engine hands bf16-cast parameters to make_cls_row
    to_bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    ref = np.asarray(j_make_cls_row(to_bf(cls), to_bf(pos0), to_bf(lns), to_bf(lnb))
                     .astype(jnp.float32))
    t = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    got = ta.make_cls_row(t(cls), t(pos0), t(lns), t(lnb))
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - ref)
    assert (d <= _bf16_ulp(np.maximum(np.abs(ref), 1e-30))).all()


@pytest.mark.parametrize("seed,b", CASES)
def test_plain_assemble_matches_jax(jax_rows, seed, b):
    conv, scale, bias, pos, cls, pos0, lns, lnb = _inputs(seed, b=b)
    cls_row = _cls_row(cls, pos0, lns, lnb)
    got = ta.assemble_dense_rows(
        torch.from_numpy(conv), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(pos), cls_row, torch.from_numpy(lns), torch.from_numpy(lnb),
    )
    assert got.shape == (b * 17, 128) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    ref = jax_rows[f"{seed}-{b}"]
    np.testing.assert_array_equal(got[::17], np.broadcast_to(cls_row.float().numpy(), (b, 128)))
    d = np.abs(got - ref)
    big = np.maximum(np.abs(got), np.abs(ref))
    assert (d <= _bf16_ulp(np.maximum(big, 1e-30))).all(), d.max()
