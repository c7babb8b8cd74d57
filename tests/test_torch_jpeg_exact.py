"""The port's JPEG decoder (``jcf_tpu_torch.data.jpeg``) on the CPU against
libjpeg-turbo as the JAX package calls it: PIL's decode at full size
(``jcf_tpu/data/datasets.py``), ``Image.draft`` at 1/2, 1/4 and 1/8, and
``jcf_tpu.native`` (the system libjpeg with ``scale_denom``). The host
entropy decoder and the plain versions of the two kernels run here; the
bar is byte equality everywhere.

Besides the committed fixtures, the JPEGs are written here from seeds:
by PIL (4:4:4, 4:2:2, 4:2:0 and grayscale; baseline, progressive and
optimized tables; restart markers; quality 100 and 10; sizes from 1 px),
and by ``_write_baseline``, a small baseline writer that takes
coefficients and tables as given, for what no encoder writes from pixels:
coefficients whose IDCT leaves 16 bits, 4:4:0, 4:1:1 and other sampling
factors, restart intervals that end mid-row.
"""

import hashlib
import io
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from jcf_tpu.native import decode_batch as native_decode_batch
from jcf_tpu_torch.data import decode as tdec
from jcf_tpu_torch.data import jpeg

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "jpeg")
sys.path.insert(0, os.path.join(HERE, "fixtures"))
import make_jpeg_hashes  # noqa: E402

SETTINGS = settings(derandomize=True, deadline=None, max_examples=25)


def _fixtures():
    return make_jpeg_hashes.fixture_paths()


def _pil(data: bytes, scale: int = 1):
    """PIL's RGB decode at 1/scale, or None where draft does not reach it."""
    with Image.open(io.BytesIO(data)) as img:
        if scale > 1:
            w, h = img.size
            if w // scale == 0 or h // scale == 0:
                return None
            img.draft("RGB", (w // scale, h // scale))
            if img.decoderconfig[0] != scale:
                return None
        return np.asarray(img.convert("RGB"))


def _ours(data: bytes, scale: int = 1) -> np.ndarray:
    out = jpeg.decode_jpeg(data, "cpu", scale_denom=scale, name="test.jpg").numpy()
    return np.repeat(out, 3, axis=2) if out.shape[2] == 1 else out


def _assert_equal_to_pil(data: bytes, scales=(1, 2, 4, 8)):
    checked = 0
    for scale in scales:
        want = _pil(data, scale)
        if want is None:
            continue
        got = _ours(data, scale)
        assert got.shape == want.shape, (scale, got.shape, want.shape)
        bad = np.argwhere(got != want)
        assert bad.size == 0, (scale, len(bad), bad[:4])
        checked += 1
    assert checked


def _content(rng, h: int, w: int) -> np.ndarray:
    """Seeded uint8 RGB: waves, a hard edge and noise (sharp content gives
    large AC coefficients and chroma that differs from pixel to pixel)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7 + yy * 3) % 256, (yy * 5 + xx) % 256, (xx * yy) % 256], -1)
    img = np.where((xx < w // 2)[..., None], img, 255 - img)
    return np.clip(img + rng.integers(-40, 40, img.shape), 0, 255).astype(np.uint8)


def _pil_jpeg(tmp_path, rng, h, w, mode="RGB", **options) -> bytes:
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_content(rng, h, w)).convert(mode).save(path, **options)
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# a baseline writer from coefficients (flat Huffman codes: every DC
# category 4 bits, every AC symbol 8 bits)
# ---------------------------------------------------------------------------

_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
           34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
           30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
_DC_SYMS = list(range(12))
_AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _write_baseline(comps, width, height, sampling, tables, restart=0) -> bytes:
    """A baseline JPEG of the given quantized coefficients (int arrays
    [blocks_h, blocks_w, 64] in natural order over whole MCUs), sampling
    factors [(h, v)] and quantization tables (natural order; a table with
    an entry above 255 is written with 16-bit precision, in an SOF1
    frame); DC values within +-1023, AC within +-1023."""
    out = bytearray(b"\xff\xd8")
    for i, q in enumerate(tables):
        wide = max(q) > 255
        out += _segment(0xDB, bytes([(wide << 4) | i]) + b"".join(
            int(q[_ZIGZAG[k]]).to_bytes(2 if wide else 1, "big") for k in range(64)))
    n = len(comps)
    frame = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([n])
    for i, (h, v) in enumerate(sampling):
        frame += bytes([i + 1, (h << 4) | v, i])
    out += _segment(0xC1 if any(max(q) > 255 for q in tables) else 0xC0, frame)
    for cls, syms, length in [(0, _DC_SYMS, 4), (1, _AC_SYMS, 8)]:
        bits = [0] * 16
        bits[length - 1] = len(syms)
        out += _segment(0xC4, bytes([cls << 4]) + bytes(bits) + bytes(syms))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    out += _segment(0xDA, bytes([n]) + b"".join(bytes([i + 1, 0]) for i in range(n))
                    + bytes([0, 63, 0]))
    max_h, max_v = max(h for h, _ in sampling), max(v for _, v in sampling)
    if n == 1:
        sampling, mx, my = [(1, 1)], -(-width // 8), -(-height // 8)
    else:
        mx, my = -(-width // (8 * max_h)), -(-height // (8 * max_v))
    bits, pred, rst = _Bits(), [0] * n, 0

    def put_value(v):
        s = abs(v).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    for m in range(mx * my):
        if restart and m and m % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + (rst & 7)])
            rst, pred = rst + 1, [0] * n
        y0, x0 = divmod(m, mx)
        for c, (h, v) in enumerate(sampling):
            for yy in range(v):
                for xx in range(h):
                    blk = comps[c][y0 * v + yy, x0 * h + xx]
                    s, val = put_value(int(blk[0]) - pred[c])
                    pred[c] = int(blk[0])
                    bits.put(_DC_SYMS.index(s), 4)
                    bits.put(val, s)
                    run = 0
                    for k in range(1, 64):
                        a = int(blk[_ZIGZAG[k]])
                        if a == 0:
                            run += 1
                            continue
                        while run > 15:
                            bits.put(_AC_SYMS.index(0xF0), 8)
                            run -= 16
                        s, val = put_value(a)
                        bits.put(_AC_SYMS.index((run << 4) | s), 8)
                        bits.put(val, s)
                        run = 0
                    if run:
                        bits.put(_AC_SYMS.index(0x00), 8)
    bits.flush()
    return bytes(out + bits.out + b"\xff\xd9")


def _random_blocks(rng, shape, amplitude, density):
    blocks = np.where(rng.random((*shape, 64)) < density,
                      rng.integers(-amplitude, amplitude + 1, (*shape, 64)), 0)
    blocks[..., 0] = rng.integers(-1023, 1024, shape)
    return blocks


# ---------------------------------------------------------------------------
# the fixtures and PIL-written JPEGs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", make_jpeg_hashes.fixture_paths())
def test_fixture_equals_pil_at_every_scale(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        _assert_equal_to_pil(f.read())


@pytest.mark.parametrize("subsampling", [0, 1, 2, "gray"])
@pytest.mark.parametrize("kind", ["baseline", "progressive", "optimize"])
def test_pil_written_equals_pil(tmp_path, subsampling, kind):
    rng = np.random.default_rng(zlib.crc32(f"{subsampling} {kind}".encode()))
    mode = "L" if subsampling == "gray" else "RGB"
    options = {} if mode == "L" else {"subsampling": subsampling}
    options.update({kind: True} if kind != "baseline" else {})
    for h, w in [(1, 1), (1, 9), (9, 1), (15, 17), (31, 33), (64, 48), (77, 130)]:
        for quality in (100, 10):
            _assert_equal_to_pil(_pil_jpeg(tmp_path, rng, h, w, mode, quality=quality, **options))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_restart_markers(tmp_path, subsampling, progressive):
    """Restart intervals of 1, 3 and 7 MCUs (DRI and RSTn in the file),
    ending mid-row; progressive EOB runs stop at each restart."""
    rng = np.random.default_rng(subsampling * 2 + progressive)
    for blocks in (1, 3, 7):
        data = _pil_jpeg(tmp_path, rng, 45, 83, quality=85, subsampling=subsampling,
                         progressive=progressive, restart_marker_blocks=blocks)
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
        _assert_equal_to_pil(data)


@given(h=st.integers(1, 70), w=st.integers(1, 70), sub=st.sampled_from([0, 1, 2, "gray"]),
       quality=st.integers(5, 100), progressive=st.booleans())
@SETTINGS
def test_odd_sizes_equal_pil(h, w, sub, quality, progressive):
    """Sizes that are no multiple of the MCU: the upsamplers' edge columns
    and the context rows of h2v2 at the top and bottom."""
    rng = np.random.default_rng(h * 1000 + w)
    img = Image.fromarray(_content(rng, h, w))
    options = {"quality": quality, "progressive": progressive}
    if sub == "gray":
        img = img.convert("L")
    else:
        options["subsampling"] = sub
    buf = io.BytesIO()
    img.save(buf, "JPEG", **options)
    _assert_equal_to_pil(buf.getvalue())


# ---------------------------------------------------------------------------
# coefficients and sampling factors no encoder writes from pixels
# ---------------------------------------------------------------------------


@given(seed=st.integers(0, 2**31), table=st.sampled_from([1, 4, 255, 65535]),
       density=st.sampled_from([0.02, 0.3, 1.0]))
@SETTINGS
def test_extreme_coefficients_equal_pil(seed, table, density):
    """Random coefficients up to +-1023 and tables up to 65535 drive the
    IDCT far outside 8-bit range: 16-bit wraps in the dequantization and
    the passes, int16 saturation between them, the clamp at the end; the
    1/8 scale through the C range limit's wrap. Every block of a 512 x 8
    gray strip equals PIL's at every scale."""
    rng = np.random.default_rng(seed)
    blocks = _random_blocks(rng, (1, 64), 1023, density)
    blocks[0, ::5, 1:] = 0  # DC-only blocks (the IDCTs' zero test)
    q = rng.integers(1, table + 1, 64).tolist()
    _assert_equal_to_pil(_write_baseline([blocks], 512, 8, [(1, 1)], [q]))


@pytest.mark.parametrize("sampling", [[(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                                      [(1, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)],
                                      [(1, 4), (1, 1), (1, 1)], [(4, 2), (1, 1), (1, 1)],
                                      [(2, 2), (2, 1), (1, 1)], [(1, 1), (2, 2), (2, 2)],
                                      [(2, 2), (1, 2), (2, 1)]])
def test_sampling_factors_equal_pil(sampling):
    """4:2:0, 4:2:2, 4:4:0, 4:1:1, 4:1:0-like and mixed factors, at odd
    sizes and restart intervals of 5 MCUs, at every scale: fancy
    upsampling, box replication and the IDCT size grown instead of
    upsampling."""
    rng = np.random.default_rng(zlib.crc32(str(sampling).encode()))
    max_h, max_v = max(h for h, _ in sampling), max(v for _, v in sampling)
    for w, h in [(37, 29), (5, 3), (64, 64)]:
        mx, my = -(-w // (8 * max_h)), -(-h // (8 * max_v))
        comps = [_random_blocks(rng, (my * v, mx * hh), 40, 0.2) // 8 for hh, v in sampling]
        tables = [rng.integers(1, 30, 64).tolist() for _ in sampling]
        _assert_equal_to_pil(_write_baseline(comps, w, h, sampling, tables, restart=5))


# sampling -> scale -> (IDCT sizes, (fx, fy, method) of the chroma planes)
_SCALED = {
    "4:2:0": ([(2, 2), (1, 1), (1, 1)], {1: ([8, 8, 8], (2, 2, 3)), 2: ([4, 8, 8], (1, 1, 0)),
                                         4: ([2, 4, 4], (1, 1, 0)), 8: ([1, 2, 2], (1, 1, 0))}),
    "4:2:2": ([(2, 1), (1, 1), (1, 1)], {1: ([8, 8, 8], (2, 1, 1)), 2: ([4, 4, 4], (2, 1, 1)),
                                         4: ([2, 2, 2], (2, 1, 1)), 8: ([1, 1, 1], (2, 1, 0))}),
    "4:4:4": ([(1, 1), (1, 1), (1, 1)], {d: ([8 // d] * 3, (1, 1, 0)) for d in (1, 2, 4, 8)}),
}


@pytest.mark.parametrize("kind", sorted(_SCALED))
def test_scaled_size_rule(kind):
    """``jdmaster.c``'s per-component IDCT size: a 2x2-subsampled
    component takes twice the luma's size, so 4:2:0 is upsampled only at
    full size (at 1/8: luma 1 x 1, chroma 2 x 2); 4:2:2's chroma cannot
    grow (its rows are not subsampled) and is upsampled h2v1, fancy down
    to 1/4 and by replication at 1/8, where the smallest IDCT is 1 x 1."""
    sampling, by_scale = _SCALED[kind]
    coef = jpeg.Coefficients(99, 61, True, False, [
        jpeg.Component(h, v, 0, 0, torch.zeros(0), torch.zeros(0)) for h, v in sampling],
        torch.zeros(0), torch.zeros(0))
    for scale, (sizes, chroma) in by_scale.items():
        out_w, out_h, planes = jpeg.geometry(coef, scale)
        assert (out_w, out_h) == (-(-99 // scale), -(-61 // scale))
        assert [p.size for p in planes] == sizes
        assert (planes[0].fx, planes[0].fy, planes[0].method) == (1, 1, 0)
        assert all((p.fx, p.fy, p.method) == chroma for p in planes[1:]), (scale, planes)


# ---------------------------------------------------------------------------
# jcf_tpu.native's scaled decode, the refusals, the card's references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["f0_420_240x320.jpg", "f1_444_333x250.jpg",
                                  "f2_gray_300x280.jpg", "f4_420_540x720.jpg",
                                  "f5_444_600x560.jpg", "f6_420_1040x1100.jpg"])
def test_equals_native_at_its_scale(name):
    """``jcf_tpu.native`` decodes with the system libjpeg at scale_denom d
    (the largest of 8, 4, 2 with short side / d >= resize_to); with
    resize_to set to the decoded short side its triangle filter is the
    identity, so its output is the decode's center square, which must
    equal the port's decode at the same scale."""
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    w, h = Image.open(path).size
    for scale in (1, 2, 4, 8):
        short = min(-(-w // scale), -(-h // scale))
        if tdec.native_scale(w, h, short) != scale:
            continue  # libjpeg would pick another scale for this size
        ours = _ours(data, scale)
        top, left = (ours.shape[0] - short) // 2, (ours.shape[1] - short) // 2
        native = np.round(native_decode_batch([path], short, short) * 255).astype(np.uint8)
        np.testing.assert_array_equal(ours[top:top + short, left:left + short],
                                      native[0].transpose(1, 2, 0))


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """data with byte ``offset`` of the first ``marker`` segment's body
    set to value (offset -1: the marker byte itself)."""
    i = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[i + 1 if offset < 0 else i + 4 + offset] = value
    return bytes(out)


def test_refusals_raise_and_name_the_file(tmp_path):
    rng = np.random.default_rng(5)
    data = _pil_jpeg(tmp_path, rng, 24, 24, quality=80)
    cmyk = io.BytesIO()
    Image.fromarray(_content(rng, 16, 16)).convert("CMYK").save(cmyk, "JPEG")
    cases = {
        "arith.jpg": (_patched(data, 0xC0, -1, 0xC9), "arithmetic"),
        "lossless.jpg": (_patched(data, 0xC0, -1, 0xC3), "lossless"),
        "twelve.jpg": (_patched(data, 0xC0, 0, 12), "12-bit"),
        "cmyk.jpg": (cmyk.getvalue(), "4-component"),
        "truncated.jpg": (data[:-30], "ends early|end of file"),
        "halved.jpg": (data[:len(data) // 2], "ends early|end of file|runs past the end"),
        "noeoi.jpg": (data[:-2], "EOI|end of file"),
        "notjpeg.jpg": (b"\xff\xd8" + b"\x00" * 40, "marker"),
    }
    for name, (blob, why) in cases.items():
        path = tmp_path / name
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=f"{name}.*({why})"):
            tdec.decode_file(str(path), "cpu")


def test_libjpeg_hashes_are_current():
    """``tests/fixtures/jpeg/libjpeg_sha256.json`` (what ``chip_smoke.py``
    holds the card's decode to) covers every committed JPEG at every scale
    PIL's draft reaches, and PIL's and the port's decodes hash to it."""
    with open(make_jpeg_hashes.HASHES) as f:
        refs = json.load(f)["images"]
    assert sorted(refs) == sorted(_fixtures())
    for rel, scales in refs.items():
        with open(os.path.join(FIXTURES, rel), "rb") as f:
            data = f.read()
        want = {str(s) for s in make_jpeg_hashes.SCALES if _pil(data, s) is not None}
        assert set(scales) == want, rel
        for scale, ref in scales.items():
            pil = make_jpeg_hashes.pil_decode(os.path.join(FIXTURES, rel), int(scale))
            ours = _ours(data, int(scale))
            assert list(ours.shape) == ref["shape"]
            assert make_jpeg_hashes.digest(pil) == ref["sha256"], (rel, scale)
            assert hashlib.sha256(ours.tobytes()).hexdigest() == ref["sha256"], (rel, scale)


def test_extra_fixtures_exercise_their_paths():
    """The small fixtures stand for what the card must decode: a
    progressive frame (SOF2), restart markers (DRI), 4:2:2, an odd size."""
    def read(name):
        with open(os.path.join(FIXTURES, "extra", name), "rb") as f:
            return f.read()
    assert b"\xff\xc2" in read("x0_prog_420_97x131.jpg")
    assert b"\xff\xdd" in read("x1_rst_420_75x203.jpg")
    coef = jpeg.read_coefficients(read("x2_422_123x77.jpg"))
    assert [(c.h, c.v) for c in coef.components] == [(2, 1), (1, 1), (1, 1)]
    assert (coef.width, coef.height) == (77, 123)
