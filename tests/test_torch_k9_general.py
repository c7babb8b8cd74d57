"""K9d and K9a's masked, f32-row and non-dense branches on the persistent
int8 layer kernel (``csrc/block_int8.cu``), on the CPU.

- The plan: ``_layers_plan`` on every branch ``k9_branch`` names (the
  unfolded and folded dense routes at 50 and 82 tokens, the causal text
  tower on f32 and bf16 rows, an odd head count, the non-dense route at S
  = 64): the flags the kernel reads, the operands in its C entry's order,
  the scratch the mode needs; and the refusals on those trees. All on CPU
  tensors, nothing launched or counted.
- K9d's bits: the JAX package says ``_layer_fused_int8_kernel`` equals the
  halves at ``_MLP_NSPLIT = nsp`` bit for bit. The port's plain versions
  hold the same: ``layer_fused_int8_plain`` equals ``_halves_int8`` at
  ``_MLP_NSPLIT = 4`` (``_LAYER_NSPLIT = 4``) bit for bit in every folded
  mode and on the unfolded tree, and JAX's ``_layer_block`` in interpret
  mode agrees with both at ``test_torch_k9_branches.py``'s bars (row cos
  >= 0.999, atol = rtol = 5e-2: an int8 value flips at a rounding tie
  where the two sides' f32 sums differ in their last bits).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import jcf_tpu.ops.block_kernel as jbk
import test_torch_k9_branches as kb
import test_torch_masked_int8 as mi
import test_torch_quant_modes as qm
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.layers import layer_slice

torch.set_num_threads(1)

STATIC = tbk.FLAG_STATIC_ACT | tbk.FLAG_STATIC_CTX | tbk.FLAG_STATIC_H | tbk.FLAG_STATIC_SHIFT


def _branch_plan(branch_name, **kw):
    """(plan, layer-1 tree, rows, branch, route) of a branch of
    ``test_torch_k9_branches.py``; ``kw`` overrides the plan's arguments."""
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = kb._branch(branch_name)
    folded = tq["quant_folded"]
    dense, _ = kb._route(n_heads, s, causal)
    layer = layer_slice(tq, 1)
    x = kw.pop("x", mi._rows(1, kb.CROPS * s, e, dtype))
    args = dict(name="block_int8", tree=layer, n_layers=1, nsp=1, mid_f32=True,
                lns=kb._lns(tb, folded, 1, dtype), causal=causal, dense=dense)
    args.update(kw)
    plan = tbk._layers_plan(args["name"], x, args["tree"], s, n_heads, args["n_layers"],
                            args["nsp"], args["mid_f32"], args["lns"], causal=args["causal"],
                            dense=args["dense"])
    branch = tbk.k9_branch(layer, s, n_heads, x.dtype, causal=causal, dense=dense)
    return plan, layer, x, branch, (n_heads, s, causal, dense, folded)


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("name", list(kb.BRANCHES))
def test_layers_plan_takes_every_branch(name, nsp):
    """K9a's plan on every branch: the route's flags (the mask, the causal
    mask, the dense route, f32 rows, the folded tree and its static
    scales), the 21 operands (the tree's own weights, the LN affines in
    f32), the scratch (qkv or the dynamic hidden a row, the f32 context
    and chunk partials, the row scales)."""
    plan, layer, x, branch, (n_heads, s, causal, dense, folded) = _branch_plan(name, nsp=nsp)
    flags = plan["flags"]
    masked = causal or n_heads % 2 == 1
    assert branch == {"B causal f32 unfolded": "masked_f32", "B causal f32 folded": "masked_f32",
                      "C S = 64 unfolded": "nondense", "C S = 64 folded full+score": "nondense",
                      "A unfolded dense": "unfolded", "D 82 tokens full": "long",
                      "D 82 tokens dynamic": "long"}.get(name, "masked")
    assert bool(flags & tbk.FLAG_USE_MASK) == masked
    assert bool(flags & tbk.FLAG_CAUSAL) == causal
    assert bool(flags & tbk.FLAG_DENSE) == dense
    assert bool(flags & tbk.FLAG_F32_ROWS) == (x.dtype == torch.float32)
    assert bool(flags & tbk.FLAG_FOLDED) == folded
    assert flags & ~(STATIC | tbk.FLAG_FOLDED | tbk.FLAG_DENSE | tbk.FLAG_USE_MASK
                     | tbk.FLAG_CAUSAL | tbk.FLAG_F32_ROWS) == 0
    assert flags == (tbk.quant_flags(layer, dense=dense, use_mask=masked)
                     | (tbk.FLAG_CAUSAL if causal else 0)
                     | (tbk.FLAG_F32_ROWS if x.dtype == torch.float32 else 0))
    ops = plan["ops"]
    attn, mlp = layer["attn"], layer["mlp"]
    assert len(ops) == 21
    assert torch.equal(ops[0], attn["w_qkv"].w_int8) and torch.equal(ops[9], mlp["c_proj"].w_int8)
    assert (ops[13] is None) == ("ctx_inv" not in attn)
    assert (ops[16] is None) == ("score_shift" not in attn)
    assert all((t is None) == folded for t in ops[17:])
    assert all(t.dtype == torch.float32 for t in ops[17:] if t is not None)
    e, hidden = x.shape[1], plan["hidden"]
    assert hidden == mlp["c_fc"].w_int8.shape[0]
    static_h, static_ctx = "h_inv" in mlp, "ctx_inv" in attn
    assert plan["big"] == max(6 * e, 0 if static_h else 4 * hidden)
    assert plan["f32s"] == (not static_ctx or nsp > 1)
    assert plan["hsc"] == (not static_h)
    assert plan["rsc"] == (not (flags & tbk.FLAG_STATIC_ACT and static_ctx))


@pytest.mark.parametrize("case", ["f32 static", "masked bf16 mid", "masked stacked",
                                  "odd heads stacked", "f32 stacked", "chunks of 64",
                                  "mask on the dense route"])
def test_layers_plan_refuses_what_the_kernel_does_not_take(case):
    """ValueError before any launch, nothing counted: f32 rows with static
    scales, the masked attention or f32 rows off K9a's one layer with the
    f32 mid, an odd head count over stacked layers, 64-column hidden
    chunks, a mask on the dense route."""
    before = dict(tbk.LAUNCHES)
    with pytest.raises(ValueError):
        if case == "f32 static":
            jb, jq, tb, tq, n_heads, s, causal, dtype, e = kb._branch("B causal bf16 folded full")
            _branch_plan("B causal bf16 folded full",
                         x=mi._rows(1, kb.CROPS * s, e, torch.float32))
        elif case == "masked bf16 mid":
            _branch_plan("B odd heads folded full", name="layer_fused_int8", mid_f32=False)
        elif case == "masked stacked":
            tq = kb._branch("B causal bf16 unfolded")[3]
            tb = kb._branch("B causal bf16 unfolded")[2]
            _branch_plan("B causal bf16 unfolded", tree=tq, n_layers=2,
                         lns=kb._stacked_lns(tb, False, torch.bfloat16))
        elif case == "odd heads stacked":
            tq = kb._branch("B odd heads folded full")[3]
            _branch_plan("B odd heads folded full", tree=tq, n_layers=2)
        elif case == "f32 stacked":
            tq, tb = kb._branch("B causal f32 unfolded")[3], kb._branch("B causal f32 unfolded")[2]
            _branch_plan("B causal f32 unfolded", tree=tq, n_layers=2,
                         lns=kb._stacked_lns(tb, False, torch.float32))
        elif case == "chunks of 64":
            _branch_plan("C S = 64 folded full+score", nsp=8)  # hidden 512: 64 columns a chunk
        else:
            _branch_plan("B causal bf16 folded full", dense=True)
    assert tbk.LAUNCHES == before


def test_wrappers_keep_k9d_and_k9c_on_the_dense_route():
    """K9d and K9c refuse a causal or odd-head route before any plan, as
    before; K9a takes it (on the CPU, its plain version)."""
    jb, jq, tb, tq, n_heads, s, causal, dtype, e = kb._branch("B odd heads folded full")
    x = mi._rows(2, kb.CROPS * s, e, dtype)
    before = dict(tbk.LAUNCHES)
    with pytest.raises(ValueError):
        tbk.stream_tower_int8(x, tq, n_heads, s=s)
    with pytest.raises(ValueError):
        tbk.layer_fused_int8(x, layer_slice(tq, 0), s, n_heads)
    got = tbk.block_int8(x, layer_slice(tq, 0), s, n_heads, dense=False)
    assert torch.equal(got, tbk.block_int8_plain(x, layer_slice(tq, 0), s, n_heads, dense=False))
    assert tbk.LAUNCHES == before


def _k9d_trees():
    """(name, JAX blocks, JAX tree, port blocks, port tree, S, E) of every
    folded mode at width 128 (2 heads) and of the unfolded tree."""
    out = []
    for mode in qm.MODES:
        jp, jq, tq = qm._trees(0, mode)
        out.append((str(mode), jp["visual"]["blocks"], jq, None, tq))
    jb, jq, tb, tq, *_ = kb._branch("A unfolded dense")
    out.append(("unfolded", jb, jq, tb, tq))
    return out


K9D = _k9d_trees()


@pytest.mark.parametrize("s", [50, 82])
@pytest.mark.parametrize("i", range(len(K9D)), ids=[t[0] for t in K9D])
def test_k9d_plain_equals_the_halves_at_four_chunks(monkeypatch, i, s):
    """``layer_fused_int8_plain`` (4 hidden chunks) equals ``_halves_int8``
    at ``_MLP_NSPLIT = 4`` bit for bit, and JAX's ``_layer_block`` (K9d in
    interpret mode, ``_LAYER_NSPLIT = 4``) agrees with both."""
    name, jb, jq, tb, tq = K9D[i]
    monkeypatch.setattr(tbk, "_MLP_NSPLIT", 4)
    monkeypatch.setattr(tbk, "_LAYER_NSPLIT", 4)
    monkeypatch.setattr(jbk, "_LAYER_NSPLIT", 4)
    folded = tq["quant_folded"]
    e = tq["attn"]["w_out"].w_int8.shape[-1]
    n_heads = e // 64
    x = mi._rows(6, kb.CROPS * s, e)
    layer = layer_slice(tq, 0)
    lns = kb._lns(tb, folded, 0, torch.bfloat16)
    k9d = tbk.layer_fused_int8_plain(x, layer, s, n_heads, lns=lns)
    halves = tbk._halves_int8(x, layer, s, n_heads, lns)
    assert k9d.dtype == torch.bfloat16 and k9d.shape == x.shape
    assert torch.equal(k9d, halves)
    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jb)
    lq = jax.tree_util.tree_map(lambda a: a[0], jq)
    ref = jbk._layer_block(mi._jx(x), lp, n_heads, lq, True, s_real=s, s_pad=kb._pad16(s),
                           quant_folded=folded)
    kb._close(k9d.float().numpy(), mi._np(ref))
    kb._close(halves.float().numpy(), mi._np(ref))
    assert np.isfinite(k9d.float().numpy()).all()
