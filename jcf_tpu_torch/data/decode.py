"""Image decode of the port: ``jcf_tpu/native``'s ``decode_batch`` (the
throughput path's square sources) and the image reads of
``jcf_tpu/data/datasets.py``.

A JPEG decodes through ``data.jpeg`` on every device: Huffman decoding on
the host (``csrc/jpeg_entropy.cpp``), then the IDCT, upsampling and color
conversion as CUDA kernels on the card or as their plain versions on the
CPU, bit for bit as libjpeg-turbo decodes with its defaults. ``decode_file``
decodes at full size, as PIL does in ``jcf_tpu/data/datasets.py``:
byte-equal to ``np.asarray(Image.open(path).convert("RGB"))``.
``decode_batch`` decodes at the scale ``jcfnative.cpp:70-77`` picks (the
largest d of 8, 4, 2 with short side / d >= ``resize_to``, else full size),
so the decode equals libjpeg's inside ``jcf_tpu.native.decode_batch`` byte
for byte; ``resize_crop_batch`` then takes each image's short side to
``resize_to`` with the triangle filter of ``jcf_tpu/native/jcfnative.cpp``
(float weights, the same window and rounding) and crops the center, one
CUDA launch for the batch's CUDA tensors. Its f32 sums run in another
order than the C++ loop's, so a value on a rounding tie may land one level
off: that is the one difference left from ``jcf_tpu.native.decode_batch``.

PNG (which ``walk_test_dir`` admits) decodes with ``zlib`` and numpy on
every device: 8-bit, non-interlaced, gray, gray + alpha, RGB or RGBA
(alpha dropped, as PIL's ``convert("RGB")`` drops it). Any other file,
and a JPEG the decoder does not take (arithmetic coding, lossless, 12-bit,
CMYK, truncated or corrupt), raises and names it; nothing falls back to
another decoder.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.data import jpeg
from jcf_tpu_torch.ops.quant import true_div

# launches of the decoder's card work (CUDA tensors only): the IDCT and
# upsample + color kernels of ``data.jpeg`` and the resize + crop kernel;
# the same dict as ``jpeg.LAUNCHES``
LAUNCHES = jpeg.LAUNCHES

_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

# color type -> (channels, how the channels map to RGB)
_PNG_COLOR = {0: (1, (0, 0, 0)), 2: (3, (0, 1, 2)), 4: (2, (0, 0, 0)), 6: (4, (0, 1, 2))}


def _unfilter_row(kind: int, line: list, prev: list, bpp: int) -> list:
    """One row of Average (3) or Paeth (4) filtering undone, byte by byte
    (each byte depends on its left neighbour's result)."""
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 255
    return cur


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int, name: str) -> np.ndarray:
    """Undo the per-row PNG filters -> uint8 [h, w * bpp]."""
    stride = w * bpp
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: PNG image data has {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:  # Up
            cur = (line + prev) & 255
        elif kind in (3, 4):  # Average, Paeth
            cur = np.array(_unfilter_row(kind, line.tolist(), prev.tolist(), bpp), np.int64)
        else:
            raise ValueError(f"{name}: unknown PNG filter type {kind} in row {y}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's bytes -> uint8 [H, W, 3] RGB (8-bit, non-interlaced, gray,
    gray + alpha, RGB or RGBA); anything else raises, naming ``name``."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = len(_PNG_MAGIC), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or image data")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_COLOR or interlace:
        raise ValueError(f"{name}: PNG of bit depth {depth}, color type {color}, interlace "
                         f"{interlace}; the decoder takes 8-bit, non-interlaced gray, gray + "
                         f"alpha, RGB or RGBA")
    bpp, rgb = _PNG_COLOR[color]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise ValueError(f"{name}: corrupt PNG image data ({exc})") from exc
    pixels = _unfilter(raw, h, w, bpp, name).reshape(h, w, bpp)
    return np.ascontiguousarray(pixels[:, :, list(rgb)])


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def decode_file(path: str, device="cuda") -> torch.Tensor:
    """One image file -> uint8 [H, W, C] on ``device``: a JPEG at full size
    through ``data.jpeg`` (C = 3, or 1 for a grayscale JPEG), a PNG through
    ``decode_png`` (C = 3). Any other file raises and names it."""
    device = torch.device(device)
    data, is_jpeg = _sniff(path)
    if is_jpeg:
        return jpeg.decode_jpeg(data, device, name=path)
    return torch.from_numpy(decode_png(data, path)).to(device)


def _sniff(path: str):
    """(the file's bytes, True for a JPEG or False for a PNG); any other
    file raises and names it."""
    data = _read(path)
    if data.startswith(_JPEG_MAGIC):
        return data, True
    if data.startswith(_PNG_MAGIC):
        return data, False
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def native_scale(width: int, height: int, resize_to: int) -> int:
    """The ``scale_denom`` ``jcfnative.cpp:70-77`` decodes at: the largest
    d of 8, 4, 2 with min(width, height) // d >= resize_to, else 1."""
    short = min(width, height)
    return next((d for d in (8, 4, 2) if resize_to > 0 and short // d >= resize_to), 1)


# ---------------------------------------------------------------------------
# the short-side triangle resize + center crop
# ---------------------------------------------------------------------------


def _geometry(sw: int, sh: int, resize_to: int, out: int):
    """(rw, rh, left, top): the resized size, long side rounded down, and
    the crop's corner (``jcfnative.cpp:process_one``)."""
    if out > resize_to:
        raise ValueError(f"crop {out} larger than the resized short side {resize_to}")
    if sw <= sh:
        rw, rh = resize_to, resize_to * sh // sw
    else:
        rw, rh = resize_to * sw // sh, resize_to
    return rw, rh, (rw - out) // 2, (rh - out) // 2


def _triangle_weights(in_size: int, out_size: int, first: int, n: int):
    """Weights [n, in_size] f32 of output coordinates first .. first + n
    of an in_size -> out_size triangle resample, with ``resize_rgb``'s f32
    arithmetic: center (o + 0.5) * scale - 0.5, window [floor(center -
    support), ceil(center + support)] clamped, w = max(0, 1 - |i - center|
    / support), each times 1 / sum (the sum in tap order)."""
    f = np.float32
    scale = f(in_size) / f(out_size)
    support = max(scale, f(1.0))
    o = np.arange(first, first + n, dtype=f)
    center = (o + f(0.5)) * scale - f(0.5)
    lo = np.maximum(np.floor(center - support).astype(np.int64), 0)
    hi = np.minimum(np.ceil(center + support).astype(np.int64), in_size - 1)
    taps = int((hi - lo).max()) + 1
    idx = lo[:, None] + np.arange(taps)[None, :]
    valid = idx <= hi[:, None]
    wt = np.maximum(f(0.0), f(1.0) - np.abs(idx.astype(f) - center[:, None]) / support)
    wt = np.where(valid, wt, f(0.0)).astype(f)
    total = np.zeros(n, f)
    for t in range(taps):  # in tap order, as the C++ loop sums
        total = total + wt[:, t]
    inv = np.where(total > 0, f(1.0) / np.where(total > 0, total, f(1.0)), f(0.0)).astype(f)
    wt = (wt * inv[:, None]).astype(f)
    dense = np.zeros((n, in_size), f)
    rows = np.repeat(np.arange(n), taps)
    dense[rows[valid.reshape(-1)], idx[valid]] = wt[valid]
    return dense


def resize_crop_plain(img: torch.Tensor, resize_to: int, out_size: int) -> torch.Tensor:
    """Plain version of the resize + crop: uint8 [H, W, C] (C = 1 or 3) on
    any device -> uint8 [out, out, 3] there. Each pass is one f32 matmul
    with the filter's weight matrix (the sums in another order than the
    C++ loop's, so a value on a rounding tie may land one level off)."""
    sh, sw, ch = img.shape
    if ch not in (1, 3):
        raise ValueError(f"resize_crop takes 1 or 3 channels, got {ch}")
    rw, rh, left, top = _geometry(sw, sh, resize_to, out_size)
    wx = _triangle_weights(sw, rw, left, out_size)
    wy = _triangle_weights(sh, rh, top, out_size)
    cols = np.nonzero(wx.any(axis=0))[0]
    rows = np.nonzero(wy.any(axis=0))[0]
    c0, c1, r0, r1 = int(cols[0]), int(cols[-1]) + 1, int(rows[0]), int(rows[-1]) + 1
    dev = img.device
    x = img[r0:r1, c0:c1].expand(-1, -1, 3).float().permute(0, 2, 1)  # [rows, 3, cols]
    tmp = torch.matmul(x, torch.from_numpy(wx[:, c0:c1]).to(dev).T)  # [rows, 3, out]
    acc = torch.matmul(torch.from_numpy(wy[:, r0:r1]).to(dev),
                       tmp.reshape(r1 - r0, 3 * out_size))  # [out, 3 * out]
    acc = acc.reshape(out_size, 3, out_size).permute(0, 2, 1)
    return torch.floor(torch.clamp(acc + 0.5, 0.0, 255.0)).to(torch.uint8).contiguous()


# The batched resize + crop: one launch for every image of a call. A
# descriptor an image (int64, ``RS_FIELDS``) gives its first CTA, the
# source's device address, size and channels, the crop's corner, the two
# scales (f32 bits, as ``jcf_resize_crop`` computed them), the output's
# byte offset in [N, out, out, 3], the tile a CTA takes (``rows`` crop
# rows, ``cols`` columns, ``spans`` spans a band) and the taps a window
# holds at most. ``csrc/jpeg.cu`` holds at most ``RS_ROWS`` rows and
# ``RS_SPAN`` columns a CTA, ``RS_WX`` column weights and ``RS_WY`` row
# weights.

RS_FIELDS = ("cta0", "src", "sw", "sh", "ch", "left", "top", "sx", "sy", "offset", "rows", "cols",
             "spans", "tx", "ty")
RS_ROWS, RS_SPAN, RS_WX, RS_WY = 16, 256, 4096, 1024


@dataclasses.dataclass
class ResizeLayout:
    """A batch's resize: ``desc`` int64 [images, 15] (the kernel's table)
    and the CTAs in all."""
    desc: np.ndarray
    ctas: int


def _f32_bits(x: np.float32) -> int:
    return int(np.float32(x).view(np.int32))


def _taps(scale: np.float32) -> int:
    """The taps a window of this scale holds at most: hi - lo <= 2 *
    support + 2 (floor and ceil), plus one to spare."""
    return int(2.0 * float(max(scale, np.float32(1.0)))) + 4


def resize_layout(sources, resize_to: int, out_size: int) -> ResizeLayout:
    """The descriptor table of ``sources`` (uint8 [H, W, 1 or 3] tensors,
    read at their ``data_ptr``), image i's output at [i] of [N, out, out,
    3]. Each image's tile: the most rows a band (up to ``RS_ROWS``) whose
    row weights fit ``RS_WY``, spans of equal width (up to ``RS_SPAN``)
    whose column weights fit ``RS_WX``."""
    rows, cta = [], 0
    for i, img in enumerate(sources):
        if (img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] not in (1, 3)
                or not img.is_contiguous()):
            raise ValueError(f"resize_crop takes contiguous uint8 [H, W, 1 or 3], got {img.dtype} "
                             f"{tuple(img.shape)}")
        sh, sw, ch = img.shape
        rw, rh, left, top = _geometry(sw, sh, resize_to, out_size)
        sx, sy = np.float32(sw) / np.float32(rw), np.float32(sh) / np.float32(rh)
        tx, ty = _taps(sx), _taps(sy)
        if tx > RS_WX or ty > RS_WY:
            raise ValueError(f"resize_crop: a {sw}x{sh} source to a short side of {resize_to} "
                             f"takes windows of {tx} x {ty} taps; the kernel holds {RS_WX} x "
                             f"{RS_WY}")
        band = min(RS_ROWS, RS_WY // ty)
        cols = -(-out_size // -(-out_size // min(RS_SPAN, RS_WX // tx)))
        spans = -(-out_size // cols)
        rows.append((cta, img.data_ptr(), sw, sh, ch, left, top, _f32_bits(sx), _f32_bits(sy),
                     i * out_size * out_size * 3, band, cols, spans, tx, ty))
        cta += -(-out_size // band) * spans
    return ResizeLayout(np.array(rows, np.int64).reshape(-1, len(RS_FIELDS)), cta)


def resize_crop_batch_plain(sources, resize_to: int, out_size: int) -> torch.Tensor:
    """Plain version of ``resize_crop_batch``: ``resize_crop_plain`` image
    by image -> uint8 [N, out, out, 3]."""
    dev = sources[0].device if sources else "cpu"
    out = torch.empty((len(sources), out_size, out_size, 3), dtype=torch.uint8, device=dev)
    for i, img in enumerate(sources):
        out[i] = resize_crop_plain(img, resize_to, out_size)
    return out


def resize_crop_batch(sources, resize_to: int, out_size: int, *,
                      layout: ResizeLayout | None = None,
                      desc: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 [H, W, C] images (C = 1 or 3, sizes mixed) -> uint8 [N, out,
    out, 3]: each short side to ``resize_to`` with the triangle filter,
    then the center crop. For CUDA tensors one ``resize_crop`` launch over
    ``resize_layout(sources, ...)``'s table (``layout`` and ``desc``, its
    copy on the card, where the caller staged them; else made and copied
    here); the plain version for CPU tensors."""
    if not sources or not sources[0].is_cuda:
        return resize_crop_batch_plain(sources, resize_to, out_size)
    dev = sources[0].device
    if any(img.device != dev for img in sources):
        raise ValueError("resize_crop_batch takes sources on one device")
    if layout is None:
        layout = resize_layout(sources, resize_to, out_size)
        desc = jpeg.stage(dev, [[torch.from_numpy(layout.desc)]])[0]
    n = len(sources)
    desc = desc.view(-1, len(RS_FIELDS))
    if (desc.dtype != torch.int64 or desc.shape[0] != n or len(layout.desc) != n
            or desc.device != dev):
        raise ValueError(f"resize_crop_batch takes int64 [{n}, {len(RS_FIELDS)}] descriptors on "
                         f"the sources' device")
    out = torch.empty((n, out_size, out_size, 3), dtype=torch.uint8, device=dev)
    err = _build.load().jcf_resize_crop(desc.data_ptr(), n, layout.ctas, out_size, out.data_ptr(),
                                        _build.stream_ptr(dev))
    _build.check(err, "resize_crop")
    jpeg.count("resize_crop")
    return out


def resize_crop(img: torch.Tensor, resize_to: int, out_size: int) -> torch.Tensor:
    """uint8 [H, W, C] (C = 1 or 3) -> uint8 [out, out, 3]: the short side
    to ``resize_to`` with the triangle filter, then the center crop. For
    CUDA tensors ``resize_crop_batch``'s launch over a table of one; the
    plain version for CPU tensors."""
    if not img.is_cuda:
        return resize_crop_plain(img, resize_to, out_size)
    return resize_crop_batch([img.contiguous()], resize_to, out_size)[0]


def decode_batch(paths, resize_to: int = 256, out_size: int = 256, *, device="cuda",
                 uint8: bool = False) -> torch.Tensor:
    """Decode (at ``native_scale``) + short-side resize + center crop of
    each file, on ``device`` -> float32 [N, 3, out, out] in [0, 1] (the
    square sources of the device-crop engine, as
    ``jcf_tpu.native.decode_batch`` returns them), or with ``uint8`` the
    pixels [N, out, out, 3].

    Every file's Huffman decoding runs first, on the host, in turn (a pool
    of decoding threads ran slower on the card's host, their per-image
    Python work contending for the interpreter lock with each other and
    with the serving thread's launches); a PNG decodes on the host at full
    size and is copied on its own. Then, on the thread's decode stream, one
    pinned buffer and one copy carry the coefficients, the quantization
    tables and the three descriptor tables, and three launches serve every
    image: the IDCT, the upsample + color (``data.jpeg.DecodePlan``) and
    the resize + crop, straight into the batch's output."""
    device = torch.device(device)
    if not paths:
        out = torch.empty((0, out_size, out_size, 3), dtype=torch.uint8, device=device)
    else:
        jpegs, sources = [], []  # sources: a JPEG's index in jpegs, or a PNG's pixels
        for path in paths:
            data, is_jpeg = _sniff(path)
            if not is_jpeg:
                sources.append(torch.from_numpy(decode_png(data, path)))
                continue
            coef = jpeg.read_coefficients(data, path)
            out_w, out_h, geo = jpeg.geometry(
                coef, native_scale(coef.width, coef.height, resize_to), path)
            sources.append(len(jpegs))
            jpegs.append((coef, geo, out_w, out_h))

        def stages():
            plan = jpeg.DecodePlan(jpegs, device) if jpegs else None
            pixels = plan.outputs() if plan else []
            srcs = [pixels[s] if isinstance(s, int) else s.to(device) for s in sources]
            # the resize's table only for the kernel (the plain version takes any geometry)
            layout = resize_layout(srcs, resize_to, out_size) if device.type == "cuda" else None
            tables = (plan.tables() if plan else []) + (
                [[torch.from_numpy(layout.desc)]] if layout else [])
            staged = jpeg.stage(device, tables)
            if plan:
                plan.run(staged[:4])
            return resize_crop_batch(srcs, resize_to, out_size, layout=layout,
                                     desc=staged[-1] if layout else None)

        out = jpeg.on_decode_stream(device, stages)
    if uint8:
        return out
    return true_div(out.permute(0, 3, 1, 2).float(), 255.0)
