"""The arithmetic of the f32 pair attention's register-tiled kernel
(``csrc/text_block.cu`` ``pair_attention_tiled_kernel``: K6a's mask-free
attention on the float vision towers) on the CPU, and the tile schedule
of the wgmma int8 GEMM (``ops.int8_gemm.gemm_plan`` and
the kernel's walk over the tiles).

The kernel runs only on the card. Here its arithmetic is emulated in
numpy at the rounding points the kernel takes: each score a sum over d in
order with one f32 rounding a step (the FMA chain of a thread's register
tile), then x 1/sqrt(d); keys past S at -inf; the pair shift as the max
over both heads' keys and the floor (0 where the reference pads the keys
to a multiple of 8, -inf where it does not); p = exp(s - m) in f32; l as
the kernel adds it: each lane (key kk of 8) sums its keys kk + 8t in t
order, then the lanes butterfly over xor 1, 2, 4; PV over the keys in
order, one f32 rounding a step; the store ctx_u x (1 / max(l, 1e-30)).
The emulation is held against the JAX package's
``_paired_attention_nomask`` in f32 at HIGHEST on the reference's padded
layout, and against the port's plain version, which ``chip_smoke.py``
holds the kernel against on the card, at the card's bar 1e-5 + 1e-5 |ref|.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch
from jax import lax

import jcf_tpu.ops.block_kernel as jbk
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops import int8_gemm as tig

torch.set_num_threads(1)

D = 64
HI = lax.Precision.HIGHEST


def _fma_chain(a, b):
    """sum_d a[..., d] * b[..., d] in order, one f32 rounding a step (the
    product exact in f64, as an FMA takes it)."""
    acc = np.zeros(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]), np.float32)
    for d in range(a.shape[-1]):
        acc = (acc.astype(np.float64)
               + a[..., d].astype(np.float64) * b[..., d].astype(np.float64)).astype(np.float32)
    return acc


def _lane_sum(p, s):
    """l over the keys as the kernel adds it: lane kk sums keys kk + 8t in
    t order (keys past S add 0), then xor 1, 2, 4 across the 8 lanes."""
    s8 = -(-s // 8) * 8
    pp = np.zeros(p.shape[:-1] + (s8,), np.float32)
    pp[..., :s] = p
    part = np.zeros(p.shape[:-1] + (8,), np.float32)
    for t in range(s8 // 8):
        part = (part + pp[..., 8 * t : 8 * t + 8]).astype(np.float32)
    lanes = np.arange(8)
    for o in (1, 2, 4):
        part = (part + part[..., lanes ^ o]).astype(np.float32)
    assert (part == part[..., :1]).all()  # every lane holds the same bits
    return part[..., 0]


def tiled_emulated(qkv: np.ndarray, s: int, h: int) -> np.ndarray:
    """The tiled kernel's arithmetic on f32 qkv [B * S, 3E] -> the context
    [B * S, E]."""
    b = qkv.shape[0] // s
    q, k, v = qkv.reshape(b, s, 3, h, D).transpose(2, 0, 3, 1, 4)  # [B, H, S, D]
    sc = _fma_chain(q[:, :, :, None, :], k[:, :, None, :, :])  # [B, H, S, S]
    sc = (sc * np.float32(1.0 / np.sqrt(D))).astype(np.float32)
    pair = sc.reshape(b, h // 2, 2, s, s)
    m = np.maximum(pair.max(axis=(2, 4), keepdims=True), np.float32(tbk._pad_floor(s)))
    m = np.broadcast_to(m, (b, h // 2, 2, s, 1)).reshape(b, h, s, 1)
    p = np.exp((sc - m).astype(np.float32)).astype(np.float32)
    l = _lane_sum(p, s)[..., None]
    ctx = np.zeros((b, h, s, D), np.float32)
    for j in range(s):
        ctx = (ctx.astype(np.float64)
               + p[..., j, None].astype(np.float64) * v[:, :, None, j, :].astype(np.float64)
               ).astype(np.float32)
    out = (ctx * (np.float32(1.0) / np.maximum(l, np.float32(1e-30))).astype(np.float32))
    return out.astype(np.float32).transpose(0, 2, 1, 3).reshape(b * s, h * D)


def _jax_pair(qkv: np.ndarray, s: int, h: int) -> np.ndarray:
    """``_paired_attention_nomask`` in f32 at HIGHEST on the float towers'
    layout (S padded to a multiple of 8 with zero rows) -> the real rows."""
    b, e = qkv.shape[0] // s, h * D
    s_pad = -(-s // 8) * 8
    q3 = np.zeros((b, s_pad, 3 * e), np.float32)
    q3[:, :s] = qkv.reshape(b, s, 3 * e)
    out = jbk._paired_attention_nomask(jnp.asarray(q3), h, D, 1.0 / np.sqrt(D), b, s_pad, HI,
                                       s_real=s)
    return np.asarray(out, np.float32).reshape(b, s_pad, e)[:, :s].reshape(b * s, e)


def _qkv(s, h, crops, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((crops * s, 3 * h * D)) * 0.5).astype(np.float32)


def _close(got, ref):
    """The card's f32 bar: |diff| <= 1e-5 + 1e-5 |ref|."""
    assert np.isfinite(got).all()
    assert (np.abs(got - ref) <= 1e-5 + 1e-5 * np.abs(ref)).all(), float(np.abs(got - ref).max())


@pytest.mark.parametrize("s", [50, 54, 64, 82, 127])
def test_tiled_emulation_matches_jax(s):
    """The tiled kernel's arithmetic against the reference at the towers'
    lengths (50: ViT-B/32; 54: jcf-predict's prompted tower; 64: no pad
    keys, no floor; 82: 288²; 127: the longest)."""
    qkv = _qkv(s, 4, 2, s)
    _close(tiled_emulated(qkv, s, 4), _jax_pair(qkv, s, 4))


@pytest.mark.parametrize("s", [50, 54, 64, 82, 127])
def test_tiled_emulation_matches_the_plain_version(s):
    """... and against the plain version the card holds the kernel to."""
    qkv = _qkv(s, 4, 2, s + 1)
    ref = tbk.pair_attention_plain(torch.from_numpy(qkv), s, 4).numpy()
    _close(tiled_emulated(qkv, s, 4), ref)


def test_floor_holds_when_every_score_is_negative():
    """k = -4 q: every real score negative, so where S is not a multiple
    of 8 the shift is the pad keys' 0 (S = 50) and the pair max where it is
    (S = 56); the emulated kernel follows the reference in both."""
    for s in (50, 56):
        qkv = _qkv(s, 2, 1, 7)
        qkv[:, 2 * D : 4 * D] = -4 * qkv[:, : 2 * D]
        _close(tiled_emulated(qkv, s, 2), _jax_pair(qkv, s, 2))


@settings(max_examples=12, deadline=None, derandomize=True)
@given(s=st.integers(1, 127), h=st.sampled_from([2, 4]), seed=st.integers(0, 2**16))
def test_tiled_emulation_at_any_length(s, h, seed):
    """Any S the kernel takes (1-127: the partial last unit of 8 rows, the
    partial last key slot, the S4 padding of PV) against the plain version."""
    qkv = _qkv(s, h, 2, seed)
    ref = tbk.pair_attention_plain(torch.from_numpy(qkv), s, h).numpy()
    _close(tiled_emulated(qkv, s, h), ref)


def test_lane_sum_differs_from_the_row_order_only_in_rounding():
    """The kernel's l adds the same p in another order than the row loop
    (per lane over key blocks, then the warp): equal within f32 rounding."""
    p = np.random.default_rng(3).random((5, 50)).astype(np.float32)
    np.testing.assert_allclose(_lane_sum(p, 50), p.astype(np.float64).sum(-1), rtol=1e-6)


def test_pair_attention_f32_on_the_cpu_is_the_plain_version_and_counts_nothing():
    """CPU rows take the plain version, whatever the kernel would refuse on
    the card (head dim 32 here), and count no launch."""
    before = dict(tbk.LAUNCHES)
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal((100, 3 * 4 * 32),
                                                                    dtype=np.float32))
    assert torch.equal(tbk.pair_attention(qkv, 50, 4), tbk.pair_attention_plain(qkv, 50, 4))
    assert tbk.LAUNCHES == before


# ---------------------------------------------------------------------------
# the int8 GEMM's tile schedule
# ---------------------------------------------------------------------------

def block_tiles(block: int, blocks: int, m: int, n: int, bn: int) -> list:
    """The (row, column) origins of the output tiles that ``block`` of a
    grid of ``blocks`` computes, in the kernel's order
    (``csrc/int8_gemm.cu``: tiles N-fastest, the block's index, then every
    ``blocks``-th)."""
    tiles_n = -(-n // bn)
    return [((t // tiles_n) * tig.BM, (t % tiles_n) * bn)
            for t in range(block, -(-m // tig.BM) * tiles_n, blocks)]


# (epilogue, M, N, K): the patch embed (bn 256, persistent), ViT-B/32's
# qkv (bn 128, a block a tile) and c_proj (bn 128, persistent), the int8
# text tower's c_proj (39,424 rows), and ragged shapes: M under one row
# tile with N past a tile's edge (s32 there on bn 128), more tiles than
# blocks, one tile
SCHEDULES = [("s32", 401_408, 768, 3072), ("bf16", 409_600, 2304, 768),
             ("residual", 409_600, 768, 3072), ("residual_f32_rows", 39_424, 512, 2048),
             ("s32", 127, 192, 3072), ("bf16", 4097, 2304, 3072), ("gelu_quant", 1, 64, 192)]


@pytest.mark.parametrize("epilogue,m,n,k", SCHEDULES)
def test_gemm_schedule_covers_every_tile_once(epilogue, m, n, k):
    """The blocks of ``gemm_plan``'s grid walk every 128 x bn output tile
    exactly once, and only tiles that touch the output; from K = 2048 on
    the grid holds the blocks that fit on the SMs at once (one an SM at bn
    256, two at 128), below it a block takes one tile."""
    sms = 132
    bn, blocks = tig.gemm_plan(epilogue, m, n, k, sms)
    assert bn == (256 if epilogue == "s32" and n % 256 == 0 else 128)
    tiles = [t for b in range(blocks) for t in block_tiles(b, blocks, m, n, bn)]
    want = [(r, c) for r in range(0, m, tig.BM) for c in range(0, n, bn)]
    assert sorted(tiles) == want
    per_sm = 1 if bn == 256 else 2
    assert blocks == (min(len(want), sms * per_sm) if k >= 2048 else len(want))


def test_gemm_schedule_walks_n_fastest():
    """The blocks in flight share A's row tiles: the first 132 tiles of the
    patch embed (401,408 x 3072 -> 768, bn 256) cover 44 row tiles of 128;
    block 0's next tile is 132 on."""
    bn, blocks = tig.gemm_plan("s32", 401_408, 768, 3072, 132)
    first = [block_tiles(b, blocks, 401_408, 768, bn)[0] for b in range(blocks)]
    assert (bn, blocks, tig.BM) == (256, 132, 128) and len({r for r, _ in first}) == 44
    assert block_tiles(0, blocks, 401_408, 768, bn)[:2] == [(0, 0), (44 * 128, 0)]
