"""The tile geometry of the port's three wgmma GEMMs (``csrc/int8_gemm.cu``,
``csrc/bf16_gemm.cu``, ``csrc/f32_gemm.cu``): the Python side of
``csrc/wgmma_gemm.cuh``.

Each kernel computes output tiles of 128 rows (two consumer warpgroups of
64) by ``bn`` columns, block b of a grid of B taking tiles b, b + B, ...
(N-fastest). Each wrapper's ``gemm_plan`` picks B with ``grid``, and
refuses with ``check_shape`` the shapes whose tile arithmetic would
overflow the kernels' ``int``.
"""

from __future__ import annotations

import functools

# the output tile's rows, and its columns (the int8 GEMM's raw int32
# product also takes 256)
BM = 128
BN = 128
# from this K on the int8 and bf16 grids are persistent
PERSISTENT_K = 2048
# the kernels count rows, K bytes and tiles in int: M + 127 (the row
# tiles), K's bytes + 127 (the 128-byte K slices) and a block's walk t +
# gridDim.x (under twice the tile count: a grid has at most a block a
# tile) stay under 2^31
MAX_M = MAX_ROW_BYTES = 2**31 - BM
MAX_TILES = 2**30


def tiles(m: int, n: int, bn: int = BN) -> int:
    """The output tiles of an [m, n] product."""
    return -(-m // BM) * -(-n // bn)


def grid(m: int, n: int, bn: int, sms: int, per_sm: int, persistent: bool) -> int:
    """The grid: where ``persistent``, as many blocks as fit on the ``sms``
    SMs at once (``per_sm`` an SM), each walking the tiles N-fastest, so
    that one tile's epilogue runs while the next tile's stages load; else
    one block a tile (short mainloops: blocks that start apart keep their
    epilogues apart)."""
    t = tiles(m, n, bn)
    return min(t, sms * per_sm) if persistent else t


def check_shape(m: int, n: int, row_bytes: int, name: str, bn: int = BN) -> None:
    """Raises ``ValueError`` where M, a row's ``row_bytes`` of K or the
    tile count of an [M, N] output pass the kernels' int arithmetic."""
    if m > MAX_M or row_bytes > MAX_ROW_BYTES or tiles(m, n, bn) > MAX_TILES:
        raise ValueError(f"{name} takes M and K's bytes a row up to 2^31 - {BM} and up to 2^30 "
                         f"output tiles of {BM} x {bn}, got M={m}, N={n}, {row_bytes} bytes a row")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (the persistent grids')."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
