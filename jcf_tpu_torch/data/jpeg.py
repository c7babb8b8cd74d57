"""JPEG decode, bit for bit as libjpeg-turbo decodes with its defaults
(what PIL and ``jcf_tpu/native/jcfnative.cpp`` call), on the card and on
the CPU.

Three stages:

1. ``read_coefficients``: markers and Huffman decoding on the host
   (``csrc/jpeg_entropy.cpp``, built with g++, bound with ctypes) -> the
   int16 DCT coefficients of each component, its quantization table,
   sampling factors and block grid. A JPEG it does not take (arithmetic
   coding, lossless, 12-bit, 2 or 4 components, truncated or corrupt data)
   raises ``ValueError`` naming the file.
2. ``idct_batch``: dequantization and libjpeg's integer IDCT of each
   block of every component of a decode call into its uint8 plane:
   ``jpeg_idct_islow`` (``jidctint.c``) for 8 x 8 output, the reduced
   ``jpeg_idct_4x4`` / ``_2x2`` / ``_1x1`` (``jidctred.c``) for 4, 2 and
   1, as libjpeg-turbo's x86 SIMD code
   computes them (see below: the C's integers for any encoder's output,
   the SIMD's 16-bit arithmetic on crafted coefficients).
3. ``upsample_color_batch``: each component to the output size
   (``jdsample.c``: the triangle "fancy" upsamplers h2v1, h1v2 and h2v2
   with edge columns and rows replicated, where they apply, else box
   replication) and YCbCr -> RGB with ``jdcolor.c``'s 16-bit fixed-point
   tables; uint8 [H, W, 3], or [H, W, 1] for a grayscale JPEG.

``decode_jpeg(data, device, scale_denom=d)`` decodes at 1/d scale (d in
1, 2, 4, 8) as libjpeg does with ``scale_denom`` d (``jdmaster.c``): the
output is ceil(W / d) x ceil(H / d); each component's IDCT size starts at
8 / d and doubles while the component's subsampling lets an IDCT of twice
the size replace upsampling (at 1/2 on 4:2:0 the luma takes the 4 x 4 IDCT,
the chroma the full 8 x 8 one and no upsampling); fancy upsampling applies
only where the smallest IDCT size is above 1 and, for h2v1 and h2v2, the
component is more than 2 samples wide.

Stages 2 and 3 are CUDA kernels (``csrc/jpeg.cu``) for tensors on the card
and their plain versions (``idct_batch_plain`` on ``idct_plain``,
``upsample_color_batch_plain`` on ``upsample_color_plain``: integer torch,
the 16- and 32-bit wraps written out) for tensors on the CPU; both compute
the same integers, so the card's pixels equal the CPU's bit for bit. Each
runs once for a whole decode call (``DecodePlan``: one image in
``decode_coefficients``, every JPEG of a ``data.decode.decode_batch``),
over descriptor tables (``idct_layout``, ``upsample_layout``) that ride
with the coefficients in one pinned host buffer and one copy (``stage``):
one ``jpeg_idct`` and one ``jpeg_upsample_color`` launch a call. Each
kernel wrapper counts its launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import List, Tuple

import numpy as np
import torch

from jcf_tpu_torch import _build

# launches of the decoder's card work (CUDA tensors only); decoding threads
# count under a lock
LAUNCHES = {"jpeg_idct": 0, "jpeg_upsample_color": 0, "resize_crop": 0}
_launches_lock = threading.Lock()
# per decoding thread: its CUDA stream per device (``decode_coefficients``)
_local = threading.local()


def count(name: str) -> None:
    with _launches_lock:
        LAUNCHES[name] += 1


SCALES = (1, 2, 4, 8)
_ERR_LEN = 256


# ---------------------------------------------------------------------------
# stage 1: the host entropy decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Component:
    h: int  # sampling factors
    v: int
    blocks_w: int  # coded grid in 8 x 8 blocks (whole MCUs)
    blocks_h: int
    coefs: torch.Tensor  # int16 [blocks_h, blocks_w, 64], natural order, CPU
    quant: torch.Tensor  # int32 [64], natural order, CPU


@dataclasses.dataclass
class Coefficients:
    width: int
    height: int
    ycc: bool  # three components in YCbCr (else RGB, or one gray component)
    progressive: bool
    components: List[Component]  # their coefs and quant: views of the two below
    coefs: torch.Tensor  # int16 [every component's blocks, 64], CPU
    quant: torch.Tensor  # int32 [components, 64], CPU

    @property
    def max_h(self) -> int:
        return max(c.h for c in self.components)

    @property
    def max_v(self) -> int:
        return max(c.v for c in self.components)


def read_coefficients(data: bytes, name: str = "<bytes>") -> Coefficients:
    """A JPEG's bytes -> its quantized DCT coefficients (host, CPU
    tensors). Raises ``ValueError`` naming ``name`` for a JPEG the decoder
    does not take."""
    lib = _build.load_entropy()
    info = np.zeros(17, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    buf = np.frombuffer(data, np.uint8)
    handle = lib.jcf_jpeg_open(buf.ctypes.data, buf.size, info.ctypes.data, err, _ERR_LEN)
    if not handle:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    try:
        width, height, ncomp, ycc, progressive = (int(v) for v in info[:5])
        grids = [tuple(int(v) for v in info[5 + 4 * c:9 + 4 * c]) for c in range(ncomp)]
        total = sum(bw * bh for _, _, bw, bh in grids)
        coefs = torch.empty((total, 64), dtype=torch.int16)
        quant = torch.empty((ncomp, 64), dtype=torch.int32)
        lib.jcf_jpeg_copy(handle, coefs.data_ptr(), quant.data_ptr())
    finally:
        lib.jcf_jpeg_close(handle)
    comps, at = [], 0
    for c, (h, v, bw, bh) in enumerate(grids):
        comps.append(Component(h, v, bw, bh, coefs[at:at + bw * bh].view(bh, bw, 64), quant[c]))
        at += bw * bh
    return Coefficients(width, height, bool(ycc), bool(progressive), comps, coefs, quant)


# ---------------------------------------------------------------------------
# geometry (jdmaster.c, jdsample.c)
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plane:
    """One component on its way to the output: its IDCT size, its size
    after the IDCT (``downsampled_width`` / ``_height``), its upsampling
    factors and method (0 box replication, 1 fancy h2v1, 2 fancy h1v2,
    3 fancy h2v2)."""
    size: int
    width: int
    height: int
    fx: int
    fy: int
    method: int


def geometry(coef: Coefficients, scale_denom: int,
             name: str = "<bytes>") -> Tuple[int, int, List[Plane]]:
    """(output width, output height, one ``Plane`` per component) at
    1/``scale_denom`` scale, as libjpeg sets them up; sampling factors
    that call for fractional upsampling raise, naming ``name``."""
    if scale_denom not in SCALES:
        raise ValueError(f"scale_denom {scale_denom} is not one of {SCALES}")
    smin = 8 // scale_denom
    max_h, max_v = coef.max_h, coef.max_v
    out_w = _ceil_div(coef.width * smin, 8)
    out_h = _ceil_div(coef.height * smin, 8)
    do_fancy = smin > 1
    planes = []
    for c in coef.components:
        size = smin  # grow the IDCT instead of upsampling, where the factors allow
        while (size < 8 and (max_h * smin) % (c.h * size * 2) == 0
               and (max_v * smin) % (c.v * size * 2) == 0):
            size *= 2
        width = _ceil_div(coef.width * c.h * size, max_h * 8)
        height = _ceil_div(coef.height * c.v * size, max_v * 8)
        h_in, v_in = c.h * size // smin, c.v * size // smin
        if max_h % h_in or max_v % v_in:
            raise ValueError(f"{name}: sampling factors {c.h}x{c.v} in {max_h}x{max_v} call for "
                             f"fractional upsampling; not supported")
        fx, fy = max_h // h_in, max_v // v_in
        method = 0
        if (fx, fy) == (2, 1) and do_fancy and width > 2:
            method = 1
        elif (fx, fy) == (1, 2) and do_fancy:
            method = 2
        elif (fx, fy) == (2, 2) and do_fancy and width > 2:
            method = 3
        planes.append(Plane(size, width, height, fx, fy, method))
    return out_w, out_h, planes


# ---------------------------------------------------------------------------
# stage 2: dequantization + IDCT
# ---------------------------------------------------------------------------
#
# libjpeg-turbo runs its IDCTs through x86 SIMD code (jidctint-sse2/avx2,
# jidctred-sse2) wherever the CPU has SSE2, as PIL's and jcfnative's builds
# do. Those compute jidctint.c's and jidctred.c's integers wherever every
# intermediate fits in 16 bits, which is the case for any JPEG an encoder
# writes from 8-bit samples. Past that (crafted coefficients or tables)
# they differ from the C, and the decoder follows the SIMD code, since that
# is what the reference decodes run:
#
# - dequantization keeps the low 16 bits of coefficient x table (pmullw;
#   a 16-bit table entry above 32767 is negative, as ISLOW_MULT_TYPE);
# - the islow passes add in0 +- in4, in7 + in3 and in5 + in1 in 16 bits
#   (paddw), every product and the other sums in 32 bits (pmaddwd, paddd);
# - pass 1's outputs saturate to int16 (packssdw); where a block's AC rows
#   that pass 1 reads are all zero (rows 1-7 for 8 x 8, 1-3 and 5-7 for
#   4 x 4), each column's outputs are its dequantized DC << 2 in 16 bits;
#   the 2 x 2 IDCT has no such test and keeps column 0's pass-1 outputs in
#   32 bits for pass 2's DC term;
# - the output saturates to -128..127 (packssdw, packsswb) before the
#   level shift: a clamp where the C wraps through ``v & RANGE_MASK``.
#
# The 1 x 1 "IDCT" has no SIMD version: DESCALE(dc x table, 3) through the C
# range limit, ``table[v & 1023]`` (a clamp within [-512, 511], a wrap
# beyond). ``tests/test_torch_jpeg_exact.py`` holds all of it against PIL on
# random coefficients and tables.

CONST_BITS, PASS1_BITS = 13, 2


def _w16(x: torch.Tensor) -> torch.Tensor:
    return ((x + 32768) & 0xFFFF) - 32768


def _w32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """paddd of the rounding term, then psrad, on 32-bit values."""
    return _w32(x + (1 << (n - 1))) >> n


def _islow_1d(x, shift: int):
    """One pass of the islow IDCT over x[0..7] (16-bit values)."""
    z2, z3 = x[2], x[6]
    tmp3 = z2 * (4433 + 6270) + z3 * 4433
    tmp2 = z2 * 4433 + z3 * (4433 - 15137)
    tmp0 = _w16(x[0] + x[4]) << CONST_BITS
    tmp1 = _w16(x[0] - x[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    i7, i5, i3, i1 = x[7], x[5], x[3], x[1]
    s73, s51 = _w16(i7 + i3), _w16(i5 + i1)
    z3 = s73 * (9633 - 16069) + s51 * 9633
    z4 = s73 * 9633 + s51 * (9633 - 3196)
    t0 = i7 * (2446 - 7373) + i1 * -7373 + z3
    t3 = i7 * -7373 + i1 * (12299 - 7373) + z4
    t1 = i5 * (16819 - 20995) + i3 * -20995 + z4
    t2 = i5 * -20995 + i3 * (25172 - 20995) + z3
    return [_descale(v, shift) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _red4_1d(x, shift: int):
    """One pass of the 4 x 4 IDCT (input 4 unused)."""
    tmp0 = x[0] << (CONST_BITS + 1)
    tmp2 = x[2] * 15137 + x[6] * -6270
    tmp10, tmp12 = tmp0 + tmp2, tmp0 - tmp2
    z1, z2, z3, z4 = x[7], x[5], x[3], x[1]
    t0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697
    t2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995
    return [_descale(v, shift) for v in (tmp10 + t2, tmp12 + t0, tmp12 - t0, tmp10 - t2)]


def _red2_1d(dc: torch.Tensor, x, shift: int):
    """One pass of the 2 x 2 IDCT: the DC term ``dc`` (already shifted),
    the odd inputs x[1], x[3], x[5], x[7]."""
    t0 = x[7] * -5906 + x[5] * 6967 + x[3] * -10426 + x[1] * 29692
    return [_descale(dc + t0, shift), _descale(dc - t0, shift)]


def _clamp_output(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(-128, 127) + 128


# output size -> (one pass, pass 1's extra descale bits, the AC rows of the zero test)
_PASSES = {8: (_islow_1d, 0, [1, 2, 3, 4, 5, 6, 7]), 4: (_red4_1d, 1, [1, 2, 3, 5, 6, 7])}


def idct_plain(coefs: torch.Tensor, quant: torch.Tensor, size: int) -> torch.Tensor:
    """Plain version of ``idct``: int16 [bh, bw, 64] coefficients and an
    int32 [64] table -> uint8 [bh * size, bw * size] (int64 arithmetic
    with the 16- and 32-bit wraps written out)."""
    bh, bw, _ = coefs.shape
    c = coefs.to(torch.int64).view(bh, bw, 8, 8)
    q = _w16(quant.to(torch.int64)).view(8, 8)
    p1 = CONST_BITS - PASS1_BITS
    p2 = CONST_BITS + PASS1_BITS + 3
    if size == 1:  # C: the product in int, the RANGE_MASK table
        i = _descale(c[..., 0, 0] * q[0, 0], 3) & 1023
        out = (torch.where(i < 512, i, i - 1024) + 128).clamp(0, 255).view(bh, bw, 1, 1)
    elif size == 2:
        d = _w16(c * q)
        rows = [d[..., r, :] for r in range(8)]
        ws = torch.stack(_red2_1d(rows[0] << (CONST_BITS + 2), rows, p1 + 2), dim=-2)
        ws16 = ws.clamp(-32768, 32767)  # [bh, bw, 2, 8]
        dc = _w32(ws[..., 0] << (CONST_BITS + 2))
        out = _clamp_output(torch.stack(
            _red2_1d(dc, [ws16[..., k] for k in range(8)], p2 + 2), dim=-1))
    else:
        one_pass, extra, ac_rows = _PASSES[size]
        d = _w16(c * q)
        ws = torch.stack(one_pass([d[..., r, :] for r in range(8)], p1 + extra), dim=-2)
        ws = ws.clamp(-32768, 32767)  # [bh, bw, size, 8]
        dc_only = (c[..., ac_rows, :] == 0).flatten(-2).all(-1)
        dc = _w16(d[..., 0, :] << PASS1_BITS)[..., None, :]
        ws = torch.where(dc_only[..., None, None], dc, ws)
        out = _clamp_output(torch.stack(one_pass([ws[..., k] for k in range(8)], p2 + extra),
                                        dim=-1))
    return out.permute(0, 2, 1, 3).reshape(bh * size, bw * size).to(torch.uint8)


# The batched IDCT: one launch for every component of every image of a
# decode call. A descriptor a component (int64, ``DESC_FIELDS``) gives its
# first CTA, its first block in the packed coefficients, its block grid,
# IDCT size and table, and its plane's byte offset and row stride in the
# packed output. Each component's blocks are padded to whole CTAs of
# ``IDCT_BLOCKS`` (so a CTA serves one component and dispatches on one
# size) and each plane starts on a 16-byte boundary.

DESC_FIELDS = ("cta0", "blk0", "bw", "bh", "size", "table", "offset", "stride")
IDCT_BLOCKS = 32  # 8 x 8 blocks a CTA: 8 warps of 4 blocks, 8 lanes a block


@dataclasses.dataclass
class IdctLayout:
    """Where a batch's components go: ``desc`` int64 [components, 8] (the
    kernel's table), the coefficient blocks and CTAs in all, the packed
    output's bytes, and per image its planes' (offset, height, width)."""
    desc: np.ndarray
    blocks: int
    ctas: int
    out_bytes: int
    planes: List[List[Tuple[int, int, int]]]

    def tables(self, images) -> list:
        """The IDCT's inputs for ``images`` (this layout's argument) as
        ``stage`` takes them: the coefficients, the quantization tables and
        the descriptors."""
        return [[coef.coefs for coef, *_ in images], [coef.quant for coef, *_ in images],
                [torch.from_numpy(self.desc)]]

    def run(self, staged) -> torch.Tensor:
        """``idct_batch`` on ``tables``' parts as ``stage`` put them on a
        device -> the packed uint8 planes."""
        coefs, quant, desc = staged
        return idct_batch(coefs.view(-1, 64), quant.view(-1, 64),
                          desc.view(-1, len(DESC_FIELDS)), self)

    def views(self, out: torch.Tensor) -> List[List[torch.Tensor]]:
        """Per image its uint8 [height, width] planes in the packed
        ``out``."""
        return [[out[o:o + h * w].view(h, w) for o, h, w in mine] for mine in self.planes]


def idct_layout(images) -> IdctLayout:
    """The descriptor table of ``images``, a sequence of (``Coefficients``,
    its ``geometry`` planes): components in image order, each component's
    table its own row of the packed tables (image by image, ``coef.quant``
    in turn)."""
    rows, planes = [], []
    blk = cta = off = 0
    for coef, geo in images:
        if len(geo) != len(coef.components):
            raise ValueError(f"{len(geo)} planes for {len(coef.components)} components")
        mine = []
        for c, p in zip(coef.components, geo):
            n = c.blocks_w * c.blocks_h
            h, w = c.blocks_h * p.size, c.blocks_w * p.size
            rows.append((cta, blk, c.blocks_w, c.blocks_h, p.size, len(rows), off, w))
            mine.append((off, h, w))
            blk += n
            cta += _ceil_div(n, IDCT_BLOCKS)
            off += _ceil_div(h * w, 16) * 16
        planes.append(mine)
    desc = np.array(rows, np.int64).reshape(-1, len(DESC_FIELDS))
    return IdctLayout(desc, blk, cta, off, planes)


def idct_batch_plain(coefs: torch.Tensor, quant: torch.Tensor, desc: torch.Tensor,
                     out_bytes: int) -> torch.Tensor:
    """Plain version of ``idct_batch``: each descriptor's component through
    ``idct_plain`` into its place in a zeroed uint8 [out_bytes]."""
    out = torch.zeros(out_bytes, dtype=torch.uint8, device=coefs.device)
    for _, blk0, bw, bh, size, table, offset, stride in desc.tolist():
        plane = idct_plain(coefs[blk0:blk0 + bw * bh].view(bh, bw, 64), quant[table], size)
        out[offset:offset + bh * size * stride].view(bh * size, stride)[:, :bw * size] = plane
    return out


def idct_batch(coefs: torch.Tensor, quant: torch.Tensor, desc: torch.Tensor,
               layout: IdctLayout) -> torch.Tensor:
    """Dequantize and inverse-transform every component that ``desc``
    (``layout.desc`` on the coefficients' device) lists: int16 [blocks, 64]
    coefficients (natural order), int32 [tables, 64] tables -> the packed
    uint8 planes [layout.out_bytes]. One ``jpeg_idct`` launch for CUDA
    tensors, the plain version for CPU tensors."""
    if not coefs.is_cuda:
        return idct_batch_plain(coefs, quant, desc, layout.out_bytes)
    n = layout.desc.shape[0]
    if (coefs.dtype != torch.int16 or tuple(coefs.shape) != (layout.blocks, 64)
            or quant.dtype != torch.int32 or quant.dim() != 2 or quant.shape[1] != 64
            or desc.dtype != torch.int64 or tuple(desc.shape) != (n, len(DESC_FIELDS)) or n < 1
            or any(t.device != coefs.device or not t.is_contiguous() for t in (coefs, quant, desc))
            or coefs.data_ptr() % 16):
        raise ValueError(f"idct_batch takes contiguous int16 [{layout.blocks}, 64] coefficients "
                         f"(16-byte aligned), int32 [tables, 64] tables and int64 [{n}, 8] "
                         f"descriptors on one device")
    out = torch.empty(layout.out_bytes, dtype=torch.uint8, device=coefs.device)
    err = _build.load().jcf_jpeg_idct(coefs.data_ptr(), quant.data_ptr(), desc.data_ptr(), n,
                                      layout.ctas, out.data_ptr(), _build.stream_ptr(coefs.device))
    _build.check(err, "jpeg_idct")
    count("jpeg_idct")
    return out


def _pinned(nbytes: int) -> torch.Tensor:
    """The calling thread's pinned staging buffer, at least ``nbytes``,
    once its last copy to the card has finished (the ``--perf`` path's
    decode thread packs the next batch while the card may still read the
    previous one)."""
    done = getattr(_local, "pinned_done", None)
    if done is not None:
        done.synchronize()
    buf = getattr(_local, "pinned", None)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 2 * (0 if buf is None else buf.numel())), dtype=torch.uint8,
                          pin_memory=True)
        _local.pinned = buf
    return buf


def stage(device, parts) -> List[torch.Tensor]:
    """``parts``: lists of CPU tensors, one dtype a list -> per list its
    tensors flattened and concatenated on ``device``. On the card every
    part goes into the calling thread's pinned host buffer (each part
    16-byte aligned), then one copy on the current stream."""
    device = torch.device(device)
    flat = [[t.reshape(-1) for t in part] for part in parts]
    if device.type != "cuda":
        return [torch.cat(part).to(device) for part in flat]
    spots, at = [], 0
    for part in flat:
        nbytes = sum(t.numel() * t.element_size() for t in part)
        spots.append((at, nbytes, part[0].dtype))
        at += _ceil_div(nbytes, 16) * 16
    staged = _pinned(at)
    for (off, nbytes, dtype), part in zip(spots, flat):
        view, i = staged[off:off + nbytes].view(dtype), 0
        for t in part:
            view[i:i + t.numel()].copy_(t)
            i += t.numel()
    packed = torch.empty(at, dtype=torch.uint8, device=device)
    packed.copy_(staged[:at], non_blocking=True)
    _local.pinned_done = torch.cuda.Event()
    _local.pinned_done.record()
    return [packed[off:off + nbytes].view(dtype) for off, nbytes, dtype in spots]


def random_idct_images(rng: np.random.Generator, n: int, *, max_bw: int = 300,
                       table: int = 65535) -> list:
    """``n`` images of random content in ``idct_layout``'s form, to hold
    the IDCT against its plain version past what real files reach: 1 or 3
    components, each a grid of 1 to ``max_bw`` blocks a row and 1 to 8
    rows (so ranges end mid-CTA) at a random IDCT size (sizes mixed within
    an image), coefficients up to +-2047 (past 16 bits once dequantized;
    every fourth block DC-only, for the zero test) and tables up to
    ``table``."""
    images = []
    for _ in range(n):
        grids = [(int(rng.integers(1, max_bw + 1)), int(rng.integers(1, 9)))
                 for _ in range(int(rng.choice([1, 3])))]
        blocks = [rng.integers(-2047, 2048, (bh * bw, 64)) * (rng.random((bh * bw, 64)) < 0.3)
                  for bw, bh in grids]
        for b in blocks:
            b[::4, 1:] = 0
        coefs = torch.from_numpy(np.concatenate(blocks).astype(np.int16))
        quant = torch.from_numpy(rng.integers(1, table + 1, (len(grids), 64)).astype(np.int32))
        comps, at = [], 0
        for i, (bw, bh) in enumerate(grids):
            comps.append(Component(1, 1, bw, bh, coefs[at:at + bw * bh].view(bh, bw, 64), quant[i]))
            at += bw * bh
        coef = Coefficients(8 * grids[0][0], 8 * grids[0][1], len(grids) == 3, False, comps, coefs,
                            quant)
        images.append((coef, [Plane(int(rng.choice(SCALES)), 1, 1, 1, 1, 0) for _ in grids]))
    return images


# ---------------------------------------------------------------------------
# stage 3: upsampling + color conversion
# ---------------------------------------------------------------------------


def _upsample_plain(img: torch.Tensor, p: Plane, out_w: int, out_h: int) -> torch.Tensor:
    """One plane (uint8 [>= p.height, >= p.width]) -> int32 [out_h, out_w]
    by ``p.method``, edges replicated."""
    dev = img.device
    src = img[:p.height, :p.width].to(torch.int32)
    y = torch.arange(out_h, device=dev)
    x = torch.arange(out_w, device=dev)
    if p.method == 0:
        ys = (y // p.fy).clamp(max=p.height - 1)
        xs = (x // p.fx).clamp(max=p.width - 1)
        return src[ys][:, xs]
    # fancy: the nearer input row (or column) weighs 3/4, the further 1/4
    if p.method == 1:
        rows = src[y.clamp(max=p.height - 1)]
    else:
        near = (y // 2).clamp(max=p.height - 1)
        far = torch.where(y % 2 == 0, near - 1, near + 1).clamp(0, p.height - 1)
        rows = src[near] * 3 + src[far]
        if p.method == 2:  # h1v2: (3 near + far + 1 or 2) >> 2
            bias = torch.where(y % 2 == 0, 1, 2).view(-1, 1)
            return (rows[:, x.clamp(max=p.width - 1)] + bias) >> 2
    j = (x // 2).clamp(max=p.width - 1)
    side = torch.where(x % 2 == 0, j - 1, j + 1).clamp(0, p.width - 1)
    if p.method == 1:  # h2v1: (3 near + far + 1 or 2) >> 2
        bias = torch.where(x % 2 == 0, 1, 2)
        return (rows[:, j] * 3 + rows[:, side] + bias) >> 2
    # h2v2 on the column sums: (3 this + that + 8 or 7) >> 4
    bias = torch.where(x % 2 == 0, 8, 7)
    return (rows[:, j] * 3 + rows[:, side] + bias) >> 4


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """``jdcolor.c``'s YCbCr -> RGB on int32 samples: SCALEBITS 16, the
    tables rounded with ONE_HALF, the sums clamped to 0..255 ->
    int32 [..., 3]."""
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255)


def upsample_color_plain(planes: List[torch.Tensor], geo: List[Plane], out_w: int, out_h: int,
                         ycc: bool) -> torch.Tensor:
    """The IDCT's planes of one image (uint8, one per component) -> uint8
    [out_h, out_w, 3] (or [out_h, out_w, 1] for one component): each plane
    upsampled by its ``Plane``'s method, then YCbCr -> RGB where ``ycc``; in
    int32, image by image (the plain version of ``upsample_color_batch``'s
    work for one image)."""
    full = [_upsample_plain(img, p, out_w, out_h) for img, p in zip(planes, geo)]
    if len(full) == 1:
        out = full[0].unsqueeze(-1)
    elif ycc:
        out = ycc_to_rgb(*full)
    else:
        out = torch.stack(full, dim=-1)
    return out.to(torch.uint8)


# The batched upsample + color conversion: one launch for every image of a
# decode call. A descriptor an image (int64, ``UP_FIELDS``) gives its first
# CTA, its output's byte offset (16-byte aligned), size, components and
# YCbCr flag, the tile a CTA takes, and per plane its byte offset from the
# planes' base (the IDCT's packed output), row stride, size, factors and
# method. A CTA takes ``rows`` output rows of one image, whole rows where
# ``rows`` of them fit its shared memory (``UP_SMEM``), else one row in
# segments of ``cols`` columns; ``rows`` is capped so that a call's rows
# make at least about ``UP_CTAS`` CTAs (one large image alone, as on the
# parity path, would otherwise fill a fraction of the card).

UP_FIELDS = ("cta0", "offset", "out_w", "out_h", "n", "ycc", "rows", "cols") + tuple(
    f"{k}{i}" for i in range(3) for k in ("offset", "stride", "width", "height", "fx", "fy",
                                          "method"))
UP_SMEM = 40 * 1024  # a tile's staged output and planes (csrc/jpeg.cu)
UP_CTAS = 4 * 132  # 4 CTAs a multiprocessor of an H100 SXM
_FACTORS = {1: (2, 1), 2: (1, 2), 3: (2, 2)}  # a fancy method's (fx, fy)


@dataclasses.dataclass
class UpsampleLayout:
    """Where a batch's images go: ``desc`` int64 [images, 29] (the
    kernel's table), the CTAs in all, the packed output's bytes, and per
    image its output's (offset, out_h, out_w, components)."""
    desc: np.ndarray
    ctas: int
    out_bytes: int
    outputs: List[Tuple[int, int, int, int]]

    def views(self, out: torch.Tensor) -> List[torch.Tensor]:
        """Each image's uint8 [out_h, out_w, components] in the packed
        ``out``."""
        return [out[o:o + h * w * n].view(h, w, n) for o, h, w, n in self.outputs]


def _tile_bytes(rows: int, cols: int, n: int, geo: List[Plane]) -> int:
    """A tile's shared memory at most (``csrc/jpeg.cu``: the staged output
    with 16 bytes of room for its alignment, then per plane
    ``staged_rows`` x ``staged_pitch``)."""
    total = _ceil_div(rows * cols * n + 15, 16) * 16
    for p in geo:
        h2, v2 = p.method & 1, 2 if p.method >= 2 else 0
        pitch = ((cols - 1) // p.fx + 2 + 2 * h2 + 30) // 16 * 16
        total += ((rows - 1) // p.fy + 2 + v2) * pitch
    return total


def _largest(lo: int, hi: int, fits) -> int:
    """The largest k in [lo, hi] with ``fits(k)``, given ``fits(lo)``."""
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def _tile(out_w: int, out_h: int, n: int, geo: List[Plane], band: int) -> Tuple[int, int]:
    """(rows, cols) of an image's tiles: the most whole rows, up to
    ``band``, that fit ``UP_SMEM``, else one row and the widest segment
    that fits."""
    if _tile_bytes(1, out_w, n, geo) <= UP_SMEM:
        most = min(out_h, band)
        return _largest(1, most, lambda r: _tile_bytes(r, out_w, n, geo) <= UP_SMEM), out_w
    return 1, _largest(1, out_w, lambda c: _tile_bytes(1, c, n, geo) <= UP_SMEM)


def upsample_layout(images) -> UpsampleLayout:
    """The descriptor table of ``images``: per image (planes, out_w,
    out_h, ycc), planes one or three (byte offset, row stride, ``Plane``)
    from the planes' base. Each output starts on a 16-byte boundary; a
    tile takes at most ceil(the images' rows / ``UP_CTAS``) rows."""
    images = list(images)
    band = max(1, _ceil_div(sum(out_h for _, _, out_h, _ in images), UP_CTAS))
    rows, outputs, cta, off = [], [], 0, 0
    for planes, out_w, out_h, ycc in images:
        n = len(planes)
        geo = [p for _, _, p in planes]
        if n not in (1, 3) or out_w < 1 or out_h < 1:
            raise ValueError(f"upsample_layout takes 1 or 3 planes to a non-empty output, got {n} "
                             f"planes to {out_w}x{out_h}")
        for _, stride, p in planes:
            if (p.width < 1 or p.height < 1 or p.fx < 1 or p.fy < 1 or stride < p.width
                    or _FACTORS.get(p.method, (p.fx, p.fy)) != (p.fx, p.fy)):
                raise ValueError(f"upsample_layout: plane {p} with row stride {stride}")
        t_rows, t_cols = _tile(out_w, out_h, n, geo, band)
        fields = [cta, off, out_w, out_h, n, int(ycc), t_rows, t_cols]
        for i in range(3):
            o, stride, p = planes[i] if i < n else (0, 0, Plane(0, 0, 0, 0, 0, 0))
            fields += [o, stride, p.width, p.height, p.fx, p.fy, p.method]
        rows.append(fields)
        outputs.append((off, out_h, out_w, n))
        cta += _ceil_div(out_h, t_rows)
        off += _ceil_div(out_h * out_w * n, 16) * 16
    desc = np.array(rows, np.int64).reshape(-1, len(UP_FIELDS))
    return UpsampleLayout(desc, cta, off, outputs)


def upsample_color_batch_plain(planes: torch.Tensor, desc: torch.Tensor,
                               out_bytes: int) -> torch.Tensor:
    """Plain version of ``upsample_color_batch``: each descriptor's image
    through ``upsample_color_plain`` into its place in a zeroed uint8
    [out_bytes]."""
    out = torch.zeros(out_bytes, dtype=torch.uint8, device=planes.device)
    for row in desc.tolist():
        _, off, out_w, out_h, n, ycc = row[:6]
        views, geo = [], []
        for i in range(n):
            o, stride, width, height, fx, fy, method = row[8 + 7 * i:15 + 7 * i]
            views.append(planes[o:o + height * stride].view(height, stride))
            geo.append(Plane(0, width, height, fx, fy, method))
        img = upsample_color_plain(views, geo, out_w, out_h, bool(ycc))
        out[off:off + img.numel()] = img.view(-1)
    return out


def upsample_color_batch(planes: torch.Tensor, desc: torch.Tensor, layout: UpsampleLayout,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Upsample and color-convert every image that ``desc`` (``layout.desc``
    on the planes' device) lists: the IDCT's packed uint8 planes -> the
    packed uint8 outputs [layout.out_bytes] (into ``out`` where given). One
    ``jpeg_upsample_color`` launch for CUDA tensors, the plain version for
    CPU tensors."""
    if not planes.is_cuda:
        got = upsample_color_batch_plain(planes, desc, layout.out_bytes)
        return got if out is None else out.copy_(got)
    if planes.dtype != torch.uint8 or planes.dim() != 1:
        raise ValueError(f"upsample_color_batch takes the packed uint8 planes, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    if out is None:
        out = torch.empty(layout.out_bytes, dtype=torch.uint8, device=planes.device)
    n = len(layout.desc)
    if (desc.dtype != torch.int64 or tuple(desc.shape) != (n, len(UP_FIELDS)) or n < 1
            or not desc.is_contiguous() or desc.device != planes.device
            or out.device != planes.device
            or out.dtype != torch.uint8 or out.numel() < layout.out_bytes or out.data_ptr() % 16):
        raise ValueError(f"upsample_color_batch takes int64 [{n}, {len(UP_FIELDS)}] descriptors "
                         f"and a 16-byte aligned uint8 output of {layout.out_bytes} bytes on the "
                         f"planes' device")
    err = _build.load().jcf_jpeg_upsample_color(planes.data_ptr(), desc.data_ptr(), n, layout.ctas,
                                                out.data_ptr(), _build.stream_ptr(out.device))
    _build.check(err, "jpeg_upsample_color")
    count("jpeg_upsample_color")
    return out


def random_color_images(rng: np.random.Generator, n: int, *, max_out: int = 40,
                        sizes=None):
    """``n`` images of random planes, to hold the upsample against its
    plain version past what real files reach -> (packed uint8 planes, the
    images in ``upsample_layout``'s form). 1 or 3 planes, each by a random
    method (box replication at factors 1, 2 or 4 a side, or a fancy one),
    of the size the output calls for or 1 to 3 samples a side, in rows of
    a random stride at a random (unaligned) offset; outputs of 1 to
    ``max_out`` a side (or the (out_w, out_h) of ``sizes`` in turn), RGB
    or YCbCr."""
    chunks, images, at = [], [], 0
    for i in range(n):
        out_w, out_h = (int(v) for v in (rng.integers(1, max_out + 1, 2) if sizes is None
                                         else sizes[i]))
        planes = []
        for _ in range(int(rng.choice([1, 3]))):
            method = int(rng.integers(0, 4))
            fx, fy = _FACTORS.get(method, (int(rng.choice([1, 2, 4])), int(rng.choice([1, 2, 4]))))
            small = rng.random() < 0.3
            width = int(rng.integers(1, 4)) if small else _ceil_div(out_w, fx)
            height = int(rng.integers(1, 4)) if small else _ceil_div(out_h, fy)
            stride = width + int(rng.integers(0, 20))
            at += int(rng.integers(0, 16))
            chunks.append((at, rng.integers(0, 256, height * stride, np.uint8)))
            planes.append((at, stride, Plane(0, width, height, fx, fy, method)))
            at += height * stride
        images.append((planes, out_w, out_h, len(planes) == 3 and bool(rng.random() < 0.7)))
    packed = np.zeros(at + 16, np.uint8)
    for off, data in chunks:
        packed[off:off + data.size] = data
    return torch.from_numpy(packed), images


# ---------------------------------------------------------------------------
# the whole decode
# ---------------------------------------------------------------------------


def _decode_stream(device: torch.device) -> torch.cuda.Stream:
    streams = _local.__dict__.setdefault("streams", {})
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def on_decode_stream(device, fn):
    """``fn()`` on ``device``: on a CUDA device on the calling thread's own
    stream, which the caller's current stream then waits for (the inputs
    come from the host, so nothing before them is waited for; on the
    caller's stream the copy would wait for every kernel queued there, the
    serving thread's while ``--perf`` decodes the next batch). ``fn``
    returns one tensor, freed after the caller's use."""
    device = torch.device(device)
    if device.type != "cuda":
        return fn()
    caller, stream = torch.cuda.current_stream(device), _decode_stream(device)
    with torch.cuda.stream(stream):
        out = fn()
    caller.wait_stream(stream)
    out.record_stream(caller)
    return out


class DecodePlan:
    """Stages 2 and 3 of a decode call: ``images`` per JPEG (coefficients,
    geometry planes, out_w, out_h). ``tables()`` are the CPU tensors the
    two kernels read (the coefficients, the quantization tables, the IDCT's
    and the upsample's descriptors: ``stage``'s parts), ``run(staged)``
    launches the IDCT and the upsample on them, and ``outputs()`` are each
    image's uint8 [out_h, out_w, C], views of ``rgb``: allocated here, so
    that a table staged in the same copy may hold their addresses."""

    def __init__(self, images, device):
        self.images = images
        self.idct = idct_layout([(coef, geo) for coef, geo, _, _ in images])
        # upsample_layout's images: the planes at their offsets in the IDCT's output
        self.color = [([(off, w, p) for (off, _, w), p in zip(planes, geo)], out_w, out_h, coef.ycc)
                      for planes, (coef, geo, out_w, out_h) in zip(self.idct.planes, images)]
        self.up = upsample_layout(self.color)
        self.rgb = torch.empty(self.up.out_bytes, dtype=torch.uint8, device=device)

    def tables(self) -> list:
        return self.idct.tables(self.images) + [[torch.from_numpy(self.up.desc)]]

    def outputs(self) -> List[torch.Tensor]:
        return self.up.views(self.rgb)

    def run(self, staged) -> List[torch.Tensor]:
        planes = self.idct.run(staged[:3])
        upsample_color_batch(planes, staged[3].view(-1, len(UP_FIELDS)), self.up, self.rgb)
        return self.outputs()


def decode_coefficients(coef: Coefficients, device, scale_denom: int = 1,
                        name: str = "<bytes>") -> torch.Tensor:
    """Stages 2 and 3 on ``device``: uint8 [ceil(H / d), ceil(W / d), C]
    (C = 3, or 1 for a grayscale JPEG); one copy, one IDCT launch for all
    the components and one upsample launch, on the thread's decode stream
    (``on_decode_stream``)."""
    out_w, out_h, geo = geometry(coef, scale_denom, name)

    def stages():
        plan = DecodePlan([(coef, geo, out_w, out_h)], device)
        return plan.run(stage(device, plan.tables()))[0]

    return on_decode_stream(device, stages)


def decode_jpeg(data: bytes, device="cuda", *, scale_denom: int = 1,
                name: str = "<bytes>") -> torch.Tensor:
    """A JPEG's bytes -> uint8 [H, W, C] on ``device`` (C = 3, or 1 for a
    grayscale JPEG), bit for bit libjpeg-turbo's decode with its defaults
    at 1/``scale_denom`` scale. Raises ``ValueError`` naming ``name`` for
    a JPEG the decoder does not take; nothing falls back to another
    decoder."""
    return decode_coefficients(read_coefficients(data, name), device, scale_denom, name)
