"""Image decode of the port: ``jcf_tpu/native``'s ``decode_batch`` (the
throughput path's square sources) and the image reads of
``jcf_tpu/data/datasets.py``.

On the card a JPEG decodes with nvJPEG (``csrc/jpeg.cu``, its own library
built beside the kernels, ``_build.load_jpeg``): uint8 [H, W, 3] (or
[H, W, 1] for a grayscale JPEG) in device memory, Huffman decoding on the
host, the rest on the card. ``resize_crop`` then takes the short side to
``resize_to`` with the triangle filter of ``jcf_tpu/native/jcfnative.cpp``
(float weights, the same window and rounding) and crops the center, a
CUDA kernel for CUDA tensors. On the CPU (the tests, ``device="cpu"``) a
JPEG decodes with PIL, imported only there, and ``resize_crop`` runs its
plain version.

The one known difference from ``jcf_tpu.native.decode_batch``: libjpeg
decodes at 1/2, 1/4 or 1/8 scale inside the codec when the short side is
at least twice ``resize_to`` (``jcfnative.cpp:71-80``). nvJPEG has no
scaled decode, so those images are decoded at full size and the filter
resizes from there; the two then differ by more than rounding
(``tests/test_torch_decode.py`` and ``chip_smoke.py`` print the
difference on the committed fixtures). Below that size the decoders
differ only in their IDCT and chroma upsampling.

PNG (which ``walk_test_dir`` admits) decodes with ``zlib`` and numpy on
every device: 8-bit, non-interlaced, gray, gray + alpha, RGB or RGBA
(alpha dropped, as PIL's ``convert("RGB")`` drops it). Any other file
raises and names it; nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np
import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops.quant import true_div

# launches of the decoder's card work (CUDA tensors only): nvJPEG decodes
# and the resize + crop kernel pairs; decoding threads count under a lock
LAUNCHES = {"jpeg_decode": 0, "resize_crop": 0}
_launches_lock = threading.Lock()


def _count(name: str) -> None:
    with _launches_lock:
        LAUNCHES[name] += 1

_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

_handle = None  # nvJPEG's library handle (thread-safe), made at first use
_handle_lock = threading.Lock()
# per decoding thread: an nvJPEG decode state and a CUDA stream per device
_local = threading.local()


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


class _DecodeState:
    """One thread's nvJPEG decode state, destroyed with the thread's
    locals when the thread ends."""

    def __init__(self, lib, handle):
        self.lib = lib
        self.ptr = ctypes.c_void_p()
        st = lib.jcf_jpeg_state_create(handle, ctypes.addressof(self.ptr))
        if st != 0:
            raise RuntimeError(f"nvjpegJpegStateCreate failed: nvjpegStatus {st}")

    def __del__(self):
        if self.ptr:
            self.lib.jcf_jpeg_state_destroy(self.ptr)


def _nvjpeg():
    """(library, handle, this thread's decode state)."""
    global _handle
    lib = _build.load_jpeg()
    with _handle_lock:
        if _handle is None:
            h = ctypes.c_void_p()
            st = lib.jcf_jpeg_create(ctypes.addressof(h))
            if st != 0:
                raise RuntimeError(f"nvjpegCreateSimple failed: nvjpegStatus {st}")
            _handle = h
    state = getattr(_local, "state", None)
    if state is None:
        state = _local.state = _DecodeState(lib, _handle)
    return lib, _handle, state.ptr


def _decode_stream(device: torch.device) -> torch.cuda.Stream:
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def decode_jpeg_cuda(data: bytes, device, name: str = "<bytes>") -> torch.Tensor:
    """A JPEG's bytes -> uint8 [H, W, C] on the CUDA ``device`` through
    nvJPEG: C = 3 (RGB) for a color JPEG, 1 for a grayscale one, complete
    when this returns and safe to use on the caller's stream. Raises,
    naming ``name``, where nvJPEG cannot decode it.

    nvJPEG reuses its state's staging buffers on the next call, before the
    card has consumed them, if this decode is still queued: images
    decoded back to back while the stream was busy came out corrupted.
    So each decode runs on this thread's own stream and is waited for
    there, which waits for no other work (``chip_smoke.py`` phase 13a and
    ``tests/test_torch_gpu_ood.py`` decode under load)."""
    device = torch.device(device)
    lib, handle, state = _nvjpeg()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    st = lib.jcf_jpeg_info(handle, buf.ctypes.data, buf.size, info.ctypes.data)
    if st != 0:
        raise ValueError(f"{name}: nvJPEG cannot read this JPEG (nvjpegStatus {st})")
    comps, w, h = (int(v) for v in info[:3])
    if comps not in (1, 3):
        raise ValueError(f"{name}: a JPEG of {comps} components; the decoder takes grayscale "
                         f"or 3-component (YCbCr) JPEGs")
    caller, stream = torch.cuda.current_stream(device), _decode_stream(device)
    with torch.cuda.stream(stream):
        out = torch.empty((h, w, comps), dtype=torch.uint8, device=device)
        st = lib.jcf_jpeg_decode(handle, state, buf.ctypes.data, buf.size, comps, w,
                                 out.data_ptr(), stream.cuda_stream)
    if st != 0:
        raise ValueError(f"{name}: nvJPEG failed to decode it (nvjpegStatus {st})")
    stream.synchronize()
    out.record_stream(caller)  # freed after the caller's use, not before
    _count("jpeg_decode")
    return out


def _decode_jpeg_pil(path: str) -> np.ndarray:
    """The CPU branch (tests): PIL's decode, as ``jcf_tpu`` reads images."""
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img.convert("RGB"), np.uint8)


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


def decode_file(path: str, device="cuda") -> torch.Tensor:
    """One image file -> uint8 [H, W, C] on ``device``: a JPEG through
    nvJPEG on a CUDA device (C = 3, or 1 for a grayscale JPEG) or through
    PIL on the CPU (C = 3); a PNG through ``decode_png`` (C = 3). Any other
    file raises and names it."""
    device = torch.device(device)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_JPEG_MAGIC):
        if device.type == "cuda":
            return decode_jpeg_cuda(data, device, path)
        if device.type != "cpu":
            raise ValueError(f"{path}: JPEG decode runs on a CUDA device or the CPU, not {device}")
        return torch.from_numpy(_decode_jpeg_pil(path))
    if data.startswith(_PNG_MAGIC):
        return torch.from_numpy(decode_png(data, path)).to(device)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


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


def resize_crop(img: torch.Tensor, resize_to: int, out_size: int) -> torch.Tensor:
    """uint8 [H, W, C] (C = 1 or 3) -> uint8 [out, out, 3]: the short side
    to ``resize_to`` with the triangle filter, then the center crop. The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if not img.is_cuda:
        return resize_crop_plain(img, resize_to, out_size)
    sh, sw, ch = img.shape
    if img.dtype != torch.uint8 or ch not in (1, 3):
        raise ValueError(f"resize_crop takes uint8 [H, W, 1 or 3], got {img.dtype} "
                         f"{tuple(img.shape)}")
    _geometry(sw, sh, resize_to, out_size)
    img = img.contiguous()
    tmp = torch.empty((sh, out_size, 3), dtype=torch.float32, device=img.device)
    out = torch.empty((out_size, out_size, 3), dtype=torch.uint8, device=img.device)
    err = _build.load_jpeg().jcf_resize_crop(img.data_ptr(), sw, sh, ch, resize_to, out_size,
                                             tmp.data_ptr(), out.data_ptr(),
                                             _build.stream_ptr(img.device))
    _build.check(err, "resize_crop")
    _count("resize_crop")
    return out


def decode_batch(paths, resize_to: int = 256, out_size: int = 256, *, device="cuda",
                 uint8: bool = False) -> torch.Tensor:
    """Decode + short-side resize + center crop of each file, on
    ``device`` -> float32 [N, 3, out, out] in [0, 1] (the square sources
    of the device-crop engine, as ``jcf_tpu.native.decode_batch`` returns
    them), or with ``uint8`` the pixels [N, out, out, 3]. One thread
    decodes the files in turn: a pool of decoding threads ran slower on
    the card's host, their per-image Python work contending for the
    interpreter lock with each other and with the serving thread's
    launches."""
    device = torch.device(device)
    if not paths:
        out = torch.empty((0, out_size, out_size, 3), dtype=torch.uint8, device=device)
    else:
        out = torch.stack([resize_crop(decode_file(p, device), resize_to, out_size)
                           for p in paths])
    if uint8:
        return out
    return true_div(out.permute(0, 3, 1, 2).float(), 255.0)
