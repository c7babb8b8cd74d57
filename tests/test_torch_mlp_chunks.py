"""The int8 tower halves (K3 + K4) with the MLP's hidden width in
``_MLP_NSPLIT`` chunks, held against the JAX package on the CPU.

``_mlp_half_int8_kernel`` (``jcf_tpu/ops/block_kernel.py:656-697``) takes
one c_fc column block a chunk, quantizes a dynamic hidden per row and per
chunk, and adds c_proj's f32 partials in chunk order before the bias and
the residual; the port's ``mlp_half_int8`` does the same. The knob is set
on both packages; the JAX halves (``_halves_block``) run in interpret
mode, the port its plain versions. Bars of ``test_torch_quant_modes.py``:
within 1 bf16 ulp + 1e-3 on all but 2% of the elements, everywhere within
0.05 + 0.05 |ref| at row cos >= 0.999. The CLS rows' MLP
(``_mlp_half_cls_rows``) takes one chunk whatever the knob."""

import numpy as np
import pytest

import torch

import jcf_tpu.ops.block_kernel as jbk
import test_torch_quant_modes as qm
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.layers import layer_slice

torch.set_num_threads(1)

S = 50


@pytest.fixture
def nsplit(monkeypatch):
    def set_(n):
        for mod in (jbk, tbk):
            monkeypatch.setattr(mod, "_MLP_NSPLIT", n)
    return set_


@pytest.mark.parametrize("nsp", [2, 4])
@pytest.mark.parametrize("mode", [None, "ln", "hidden", "full"])
def test_halves_take_the_hidden_in_chunks(nsplit, mode, nsp):
    """One layer of K3 + K4 against ``_halves_block`` at the same chunk
    count: a dynamic hidden (modes dynamic and "ln") quantized per chunk,
    a static one ("hidden", "full") with its partials added per chunk."""
    nsplit(nsp)
    jp, jq, tq = qm._trees(0, mode)
    x = qm._rows(3, S)
    lp, lq = qm._jax_layer(jp, jq, 1)
    ref = jbk._halves_block(qm._jx(x), lp, qm.H, qm._bias(S), lq, True, s_real=S,
                            use_mask=False, quant_folded=True, dense=True, s_pad=qm._s_pad(S))
    got = tbk._halves_int8(x, layer_slice(tq, 1), S, qm.H)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    qm._close_bf16(got.float().numpy(), qm._np(ref), 2e-2)


@pytest.mark.parametrize("nsp", [2, 4])
def test_dynamic_hidden_scales_per_chunk(nsp):
    """The MLP half alone on the same int8 rows: the dynamic hidden's row
    scales are those of each chunk's QuickGELU (``_quant_rows`` of the
    chunk), so its output differs from the one-chunk half's."""
    _, _, tq = qm._trees(0, None)
    mlp = layer_slice(tq, 1)["mlp"]
    x = qm._rows(4, S)
    one = tbk.mlp_half_int8(x, mlp, nsp=1)
    split = tbk.mlp_half_int8(x, mlp, nsp=nsp)
    x_q, x_sc = tbk._ln_quant_plain_any(x, None)
    fc = mlp["c_fc"]
    hidden = tbk.dequant_plain(tbk.int8_matmul_plain(x_q, fc.w_int8), fc.w_scale, fc.bias, x_sc)
    hs = hidden.shape[1] // nsp
    for c in range(nsp):
        _, sc = tbk.gelu_quant_rows_plain(hidden[:, c * hs:(c + 1) * hs])
        _, sc_all = tbk.gelu_quant_rows_plain(hidden)
        assert not torch.equal(sc, sc_all)
    assert not torch.equal(one, split)
    qm._close_bf16(split.float().numpy(), one.float().numpy(), 0.5)


@pytest.mark.parametrize("nsp", [2, 4])
def test_cls_tower_takes_one_chunk_on_the_cls_rows(nsplit, nsp):
    """``run_fused_tower`` with the CLS-only last layer at the same chunk
    count as JAX's (interpret mode): the halves split the hidden, the CLS
    rows' MLP half takes one chunk (``_mlp_half_cls_rows``); the CLS rows
    at the towers' bar, row cos >= 0.999 (int8 ties compound over
    layers)."""
    nsplit(nsp)
    jp, jq, tq = qm._trees(0, None)
    x = qm._rows(3, S)
    ref = jbk.run_fused_tower(qm._jx(x), jp["visual"]["blocks"], qm.H, None, quant=jq,
                              quant_folded=True, interpret=True, flat_s=S, cls_only=True)
    got = tbk.run_fused_tower(x, tq, qm.H, flat_s=S, cls_only=True)
    assert got.shape == (qm.CROPS, qm.E) and got.dtype == torch.bfloat16
    assert qm._row_cos(got.float().numpy(), qm._np(ref)) >= 0.999
    assert np.isfinite(got.float().numpy()).all()
