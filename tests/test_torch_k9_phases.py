"""The persistent int8 layer kernel of K9a, K9c and K9d
(``csrc/block_int8.cu``) on the CPU: the arithmetic of its c_proj phase,
the route choice, and the wrapper's checks.

- c_proj: the hidden in ``nsp`` chunks, each chunk's product an exact
  int32 sum, its f32 partial (x the c_proj scale, x the chunk's row scale
  where the hidden is dynamic) added to the earlier chunks' in chunk order,
  then the bias, then the mid. A numpy emulation of those steps (int64
  products cast to int32, float32 products and sums, one rounding each) on
  the port's plain LN / c_fc / row quantization is held against JAX's
  ``_block_int8_kernel`` (``fused_block``) and ``_stream_tower_int8_kernel``
  (``_stream_tower``) in interpret mode with ``_MLP_NSPLIT`` set on both
  packages, at ``test_torch_fused_layer.py``'s bars (min row cos >= 0.999,
  atol = rtol = 5e-2: int8 values flip at rounding ties where the two
  sides' f32 sums and tanh differ in the last bits), and against the
  port's plain versions bit for bit.
- the route: every K9 launch takes the persistent kernel, on every branch
  (``k9_branch``) its wrapper reaches.
- the checks: ``_layers_plan`` refuses, on CPU tensors and before any
  launch, what the kernel does not take.
"""

import functools
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch

import jcf_tpu.ops.block_kernel as jbk
import test_torch_quant_modes as qm
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.layers import layer_slice
from jcf_tpu_torch.ops.quant import QuantizedLinear

torch.set_num_threads(1)

S = 50


@pytest.fixture
def nsplit(monkeypatch):
    def set_(n):
        for mod in (jbk, tbk):
            monkeypatch.setattr(mod, "_MLP_NSPLIT", n)
    return set_


def _proj_emulated(mid: torch.Tensor, mlp: dict, nsp: int) -> np.ndarray:
    """The kernel's MLP half before its residual add, f32 [M, E]: LN2 +
    quant, c_fc and the hidden's int8 (static, or per row and chunk) from
    the plain versions; c_proj emulated as the kernel folds its chunks."""
    fc, pr = mlp["c_fc"], mlp["c_proj"]
    x_q, x_sc = tbk._ln_quant_plain_any(mid, mlp.get("ln_inv"))
    hs = fc.w_int8.shape[0] // nsp
    if "h_inv" in mlp:
        h_inv = mlp["h_inv"].reshape(())
        h = tbk.dequant_plain(tbk.int8_matmul_plain(x_q, fc.w_int8), fc.w_scale * h_inv,
                              fc.bias * h_inv)
        h_q, h_sc = tbk.gelu_quant_plain(h, tbk.GELU_TANH_COEF / h_inv).numpy(), None
    else:
        h = tbk.dequant_plain(tbk.int8_matmul_plain(x_q, fc.w_int8), fc.w_scale, fc.bias, x_sc)
        chunks = [tbk.gelu_quant_rows_plain(h[:, c * hs:(c + 1) * hs]) for c in range(nsp)]
        h_q = np.concatenate([q.numpy() for q, _ in chunks], axis=1)
        h_sc = np.stack([sc.numpy() for _, sc in chunks], axis=1)
    w = pr.w_int8.numpy().astype(np.int64)
    scale, bias = pr.w_scale.numpy(), pr.bias.numpy()
    acc = None
    for c in range(nsp):
        sl = slice(c * hs, (c + 1) * hs)
        part = (h_q[:, sl].astype(np.int64) @ w[:, sl].T).astype(np.int32).astype(np.float32)
        part = part * scale
        if h_sc is not None:
            part = part * h_sc[:, c:c + 1]
        acc = part if acc is None else acc + part
    assert acc.dtype == np.float32
    return acc + bias


def _layer_emulated(x: torch.Tensor, layer: dict, nsp: int, bf16_mid: bool) -> torch.Tensor:
    """One dense layer: the plain attention half's f32 mid (K9a) or its
    bf16 rounding (K9c), then the emulated MLP half, in bf16."""
    mid = tbk._attn_mid_plain(x, layer["attn"], S, qm.H)
    if bf16_mid:
        mid = mid.to(torch.bfloat16)
    out = mid.float().numpy() + _proj_emulated(mid, layer["mlp"], nsp)
    return torch.from_numpy(out).to(torch.bfloat16)


@pytest.mark.parametrize("nsp", [1, 2, 4])
@pytest.mark.parametrize("mode", [None, "hidden"])
def test_block_int8_chunk_folding_matches_jax(nsplit, mode, nsp):
    """K9a (f32 mid) at nsp chunks: the emulation against JAX's
    ``_block_int8_kernel`` in interpret mode, and equal to the plain
    version bit for bit."""
    nsplit(nsp)
    jp, jq, tq = qm._trees(0, mode)
    x = qm._rows(6, S)
    lp, lq = qm._jax_layer(jp, jq, 1)
    layer = layer_slice(tq, 1)
    got = _layer_emulated(x, layer, nsp, bf16_mid=False)
    assert torch.equal(got, tbk.block_int8_plain(x, layer, S, qm.H))
    ref = jbk.fused_block(qm._jx(x), lp, qm.H, qm._bias(S), quant_layer=lq, interpret=True,
                          s_real=S, use_mask=False, quant_folded=True, dense=True,
                          s_pad=qm._s_pad(S))
    _close(got, qm._np(ref))


@pytest.mark.parametrize("nsp", [1, 2, 4])
def test_stream_tower_chunk_folding_matches_jax(nsplit, nsp):
    """K9c (bf16 mid) over both layers of the dynamic tree at nsp chunks:
    the emulation layer by layer against JAX's ``_stream_tower_int8_kernel``
    in interpret mode, and equal to the plain version bit for bit."""
    nsplit(nsp)
    jp, jq, tq = qm._trees(0, None)
    x = qm._rows(7, S)
    got = x
    for i in range(2):
        got = _layer_emulated(got, layer_slice(tq, i), nsp, bf16_mid=True)
    assert torch.equal(got, tbk.stream_tower_int8_plain(x, tq, qm.H, s=S))
    ref = jbk._stream_tower(qm._jx(x), jp["visual"]["blocks"], jq, qm.H, qm._bias(S), s_real=S,
                            s_pad=qm._s_pad(S), interpret=True, quant_folded=True)
    _close(got, qm._np(ref))


def _close(got, ref):
    got = got.float().numpy()
    assert qm._row_cos(got, ref) >= 0.999
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _zero_tree(heads: int, folded: bool) -> dict:
    """A one-layer int8 tree of zeros at width 64 heads, hidden 128: the
    shapes and types ``_layers_plan`` checks, no weights' values."""
    e = 64 * heads

    def lin(n, k):
        return QuantizedLinear(torch.zeros(n, k, dtype=torch.int8), torch.ones(n), torch.zeros(n))

    return {"attn": {"w_qkv": lin(3 * e, e), "w_out": lin(e, e)},
            "mlp": {"c_fc": lin(128, e), "c_proj": lin(e, 128)}, "quant_folded": folded}


@settings(derandomize=True, max_examples=200, deadline=None)
@given(s=st.integers(1, 127), heads=st.integers(1, 16), causal=st.booleans(),
       folded=st.booleans(), f32=st.booleans())
def test_the_new_kernel_takes_the_dense_branches(s, heads, causal, folded, f32):
    """Every K9 launch takes the persistent kernel (csrc/block_int8.cu): K9a
    on every branch (the dense ones: folded at S <= 64 "", 65-127 tokens
    "long", unfolded; the masked, f32 and non-dense ones), K9c and K9d on
    the dense route their wrappers take. The plan (flags, operands,
    scratch) is made on CPU tensors, nothing launched."""
    tree = _zero_tree(heads, folded)
    dense = not causal and heads % 2 == 0 and s % 16 != 0
    dt = torch.float32 if f32 else torch.bfloat16
    branch = tbk.k9_branch(tree, s, heads, dt, causal=causal, dense=dense)
    if dense and not f32:
        assert branch == ("unfolded" if not folded else "long" if s > 64 else "")
    else:
        assert branch in ("masked", "masked_f32", "nondense")
    x = torch.zeros(s, 64 * heads, dtype=dt)
    lns = (None, None) if folded else tuple(
        {"scale": torch.ones(64 * heads, dtype=dt), "bias": torch.zeros(64 * heads, dtype=dt)}
        for _ in range(2))
    plan = tbk._layers_plan("block_int8", x, tree, s, heads, 1, 1, True, lns, causal=causal,
                            dense=dense)
    masked = causal or heads % 2 == 1
    assert bool(plan["flags"] & tbk.FLAG_USE_MASK) == masked
    assert bool(plan["flags"] & tbk.FLAG_CAUSAL) == causal
    assert bool(plan["flags"] & tbk.FLAG_DENSE) == dense
    assert bool(plan["flags"] & tbk.FLAG_F32_ROWS) == f32
    if dense and not f32:
        for name in ("layer_fused_int8", "stream_tower_int8"):
            assert tbk._layers_plan(name, x, tree, s, heads, 1, 1, False, lns)["flags"] == \
                plan["flags"]
    assert not hasattr(tbk, "k9_source") and not hasattr(tbk, "PERSISTENT_BRANCHES")


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _plan(x, tree, s=S, n_layers=1, nsp=1, mid_f32=True, lns=(None, None)):
    return tbk._layers_plan("block_int8", x, tree, s, qm.H, n_layers, nsp, mid_f32, lns)


def test_layers_plan_takes_the_serving_trees():
    """The dense route's folded modes and the unfolded tree: the flags,
    the operands in the C entry's order, the scratch the mode needs."""
    for mode in (None, "ln", "hidden", "full", "full+score"):
        _, _, tq = qm._trees(0, mode)
        plan = _plan(qm._rows(1, S), layer_slice(tq, 1))
        flags = plan["flags"]
        assert flags & tbk.FLAG_DENSE and flags & tbk.FLAG_FOLDED
        assert not flags & (tbk.FLAG_USE_MASK | tbk.FLAG_CAUSAL | tbk.FLAG_F32_ROWS)
        assert len(plan["ops"]) == 21 and plan["hidden"] == 4 * qm.E
        static_h = bool(flags & tbk.FLAG_STATIC_H)
        assert plan["big"] == max(6 * qm.E, 0 if static_h else 16 * qm.E)
        assert plan["hsc"] == (not static_h)
        assert plan["f32s"] == (not flags & tbk.FLAG_STATIC_CTX)
        assert plan["rsc"] == (not (flags & tbk.FLAG_STATIC_ACT and flags & tbk.FLAG_STATIC_CTX))
    assert _plan(qm._rows(1, S), layer_slice(tq, 1), nsp=2)["f32s"]


def test_layers_plan_takes_the_unfolded_affines_in_f32():
    _, _, tq = qm._trees(0, None)
    layer = layer_slice(tq, 1)
    lns = tuple({"scale": torch.ones(qm.E, dtype=torch.bfloat16),
                 "bias": torch.zeros(qm.E, dtype=torch.bfloat16)} for _ in range(2))
    unfolded = {**layer, "quant_folded": False}
    plan = _plan(qm._rows(1, S), unfolded, lns=lns)
    assert not plan["flags"] & tbk.FLAG_FOLDED
    assert all(t.dtype == torch.float32 for t in plan["ops"][17:])


@pytest.mark.parametrize("case", ["s128", "f32", "odd_heads", "width", "chunks", "masked",
                                  "operand"])
def test_layers_plan_refuses_before_any_launch(monkeypatch, case):
    """Each refusal is a ValueError on CPU tensors; nothing is counted:
    S = 128, f32 rows with the bf16 mid (K9c, K9d), an odd head count on
    the dense route, a width not 64 a head, 64-column hidden chunks, a mask
    on the dense route, an operand of the wrong type."""
    _, _, tq = qm._trees(0, None)
    layer = layer_slice(tq, 1)
    x = qm._rows(1, S)
    before = dict(tbk.LAUNCHES)
    kw = {}
    if case == "s128":
        kw = {"s": 128, "x": torch.zeros(128, qm.E, dtype=torch.bfloat16)}
    elif case == "f32":
        kw = {"x": x.float(), "mid_f32": False}
    elif case == "odd_heads":
        kw = {"x": torch.zeros(S, 192, dtype=torch.bfloat16)}
    elif case == "width":
        kw = {"x": torch.zeros(S, 64 * qm.H + 8, dtype=torch.bfloat16)}
    elif case == "chunks":
        kw = {"nsp": 8}  # 512 / 8 = 64 columns a chunk
    elif case == "masked":
        flags = tbk.quant_flags(layer)
        monkeypatch.setattr(tbk, "quant_flags", lambda tree, **k: flags | tbk.FLAG_USE_MASK)
    else:
        layer = {**layer, "mlp": {**layer["mlp"], "c_proj": layer["mlp"]["c_proj"]._replace(
            w_scale=layer["mlp"]["c_proj"].w_scale.double())}}
    xs = kw.pop("x", x)
    heads = xs.shape[1] // 64 if case == "odd_heads" else qm.H
    with pytest.raises(ValueError):
        tbk._layers_plan("block_int8", xs, layer, kw.pop("s", S), heads, 1, kw.pop("nsp", 1),
                         kw.pop("mid_f32", True))
    assert tbk.LAUNCHES == before


def test_cpu_rows_take_the_plain_versions():
    """On CPU tensors the wrappers run their plain versions and count no
    launch, whatever the route."""
    _, _, tq = qm._trees(0, "full")
    x = qm._rows(2, S)
    before = dict(tbk.LAUNCHES)
    assert torch.equal(tbk.block_int8(x, layer_slice(tq, 0), S, qm.H),
                       tbk.block_int8_plain(x, layer_slice(tq, 0), S, qm.H))
    assert torch.equal(tbk.stream_tower_int8(x, tq, qm.H, s=S),
                       tbk.stream_tower_int8_plain(x, tq, qm.H, s=S))
    assert tbk.LAUNCHES == before
    assert math.isfinite(float(tbk.stream_tower_int8(x, tq, qm.H, s=S).float().abs().max()))
