"""The batched upsample + color conversion (``data.jpeg.upsample_layout``,
``upsample_color_batch_plain``, ``DecodePlan``) and the batched resize +
crop (``data.decode.resize_layout``, ``resize_crop_batch_plain``) on the
CPU.

- The upsample's table: 16-byte aligned outputs, each image's CTAs after
  the last one's (no CTA serves two images), each tile within the
  kernel's shared memory and contiguous in the output (whole rows, or one
  row), its rows capped so that one large image alone spreads over the
  card, grayscale and color images mixed, an empty batch.
- ``upsample_color_batch_plain`` over one table equals
  ``upsample_color_plain`` image by image, bit for bit: every committed
  JPEG at every scale in one batch, and random planes (all four methods,
  planes of 1 to 3 samples a side, odd sizes, 1 and 3 planes mixed).
- The resize's table: the scales as ``jcf_resize_crop`` computed them
  (f32 bits), the crop's corner, tiles within the kernel's limits, the
  taps a window can hold, each image's CTAs after the last one's.
- ``resize_crop_batch_plain`` equals ``resize_crop_plain`` image by image:
  an upscale, a 4x downscale of a PNG (support over 1), a crop smaller
  than ``resize_to``, 1 and 3 channels mixed; on the CPU ``decode_batch``
  takes a downscale too steep for the kernel's table.
"""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from jcf_tpu_torch.data import decode as tdec
from jcf_tpu_torch.data import jpeg

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "jpeg")
sys.path.insert(0, os.path.join(HERE, "fixtures"))
import make_jpeg_hashes  # noqa: E402

SETTINGS = settings(derandomize=True, deadline=None, max_examples=20)
UP = {name: i for i, name in enumerate(jpeg.UP_FIELDS)}
RS = {name: i for i, name in enumerate(tdec.RS_FIELDS)}


def _fixture_images(scales=jpeg.SCALES):
    """(coefficients, geometry planes, out_w, out_h) of every committed
    JPEG at each of ``scales``."""
    images = []
    for rel in make_jpeg_hashes.fixture_paths():
        with open(os.path.join(FIXTURES, rel), "rb") as f:
            coef = jpeg.read_coefficients(f.read(), rel)
        for d in scales:
            out_w, out_h, geo = jpeg.geometry(coef, d, rel)
            images.append((coef, geo, out_w, out_h))
    return images


def _check_upsample_layout(images, layout):
    """Every descriptor row against its image: the fields, the tile and
    the output's alignment."""
    desc = layout.desc
    assert desc.dtype == np.int64 and desc.shape == (len(images), 29)
    cta = off = 0
    for d, (planes, out_w, out_h, ycc), out in zip(desc, images, layout.outputs):
        n = len(planes)
        assert d[UP["cta0"]] == cta and d[UP["offset"]] == off and off % 16 == 0
        assert (d[UP["out_w"]], d[UP["out_h"]], d[UP["n"]], d[UP["ycc"]]) == (out_w, out_h, n,
                                                                               int(ycc))
        assert out == (off, out_h, out_w, n)
        for i, (o, stride, p) in enumerate(planes):
            assert [d[UP[f"{k}{i}"]] for k in ("offset", "stride", "width", "height", "fx", "fy",
                                               "method")] == [o, stride, p.width, p.height, p.fx,
                                                              p.fy, p.method]
        rows, cols = int(d[UP["rows"]]), int(d[UP["cols"]])
        assert 1 <= rows <= out_h and 1 <= cols <= out_w and (cols == out_w or rows == 1)
        assert rows <= max(1, -(-sum(h for _, _, h, _ in images) // jpeg.UP_CTAS))
        assert jpeg._tile_bytes(rows, cols, n, [p for *_, p in planes]) <= jpeg.UP_SMEM
        # no CTA straddles two images: this one's CTAs cover its rows
        ctas = -(-out_h // rows)
        assert (ctas - 1) * rows < out_h <= ctas * rows
        cta, off = cta + ctas, off + -(-out_h * out_w * n // 16) * 16
    assert (layout.ctas, layout.out_bytes) == (cta, off)


def test_upsample_layout_of_the_fixtures_at_every_scale():
    """All committed JPEGs at every scale in one table: gray (one plane)
    among color (three), box, h2v1 (4:2:2) and h2v2 (4:2:0) planes (no
    committed file is 4:4:0; the random planes below hold h1v2), every
    output 16-byte aligned."""
    plan = jpeg.DecodePlan(_fixture_images(), "cpu")
    images = plan.color
    for (planes, *_), offsets in zip(images, plan.idct.planes):
        assert [(o, stride) for o, stride, _ in planes] == [(o, w) for o, _, w in offsets]
    _check_upsample_layout(images, plan.up)
    counts = {len(planes) for planes, *_ in images}
    assert counts == {1, 3}
    methods = {p.method for planes, *_ in images for *_, p in planes}
    assert methods == {0, 1, 3}


def test_upsample_layout_of_an_empty_batch():
    layout = jpeg.upsample_layout([])
    assert layout.desc.shape == (0, 29) and layout.ctas == layout.out_bytes == 0
    assert layout.outputs == [] and layout.views(torch.zeros(0, dtype=torch.uint8)) == []


def test_upsample_tile_of_rows_too_wide_for_shared_memory():
    """A row that does not fit a CTA's shared memory is cut into column
    segments of one row; a narrow image takes many whole rows a CTA, up to
    the call's cap."""
    wide = [[(0, 14100, jpeg.Plane(0, 14100, 2, 1, 1, 0))] * 3, 14001, 2, True]
    tall = [[(0, 4, jpeg.Plane(0, 2, 1500, 1, 2, 2))], 2, 300000, False]
    layout = jpeg.upsample_layout([wide, tall])
    _check_upsample_layout([wide, tall], layout)
    (rows_w, cols_w), (rows_t, cols_t) = layout.desc[:, [UP["rows"], UP["cols"]]].tolist()
    assert rows_w == 1 and cols_w < 14001
    assert not jpeg._tile_bytes(1, cols_w + 1, 3, [p for *_, p in wide[0]]) <= jpeg.UP_SMEM
    assert cols_t == 2 and rows_t == -(-300002 // jpeg.UP_CTAS) > 100


def test_upsample_tile_spreads_one_image_over_the_card():
    """The largest fixture alone at full size (the parity path's call)
    takes bands of ceil(out_h / ``UP_CTAS``) rows, fewer than its shared
    memory holds, so its CTAs outnumber the card's 132 multiprocessors
    twice over; a 128-image ``--perf`` batch keeps the most rows that fit."""
    paths = [os.path.join(FIXTURES, f) for f in sorted(os.listdir(FIXTURES)) if f.endswith(".jpg")]
    largest = max(paths, key=os.path.getsize)
    with open(largest, "rb") as f:
        coef = jpeg.read_coefficients(f.read(), largest)
    out_w, out_h, geo = jpeg.geometry(coef, 1, largest)
    plan = jpeg.DecodePlan([(coef, geo, out_w, out_h)], "cpu")
    rows = int(plan.up.desc[0, UP["rows"]])
    assert rows == -(-out_h // jpeg.UP_CTAS) and plan.up.ctas > 2 * 132
    assert jpeg._tile_bytes(rows + 1, out_w, 3, geo) <= jpeg.UP_SMEM
    batch = []
    for i in range(128):
        with open(paths[i % len(paths)], "rb") as f:
            coef = jpeg.read_coefficients(f.read(), paths[i % len(paths)])
        w, h, geo = jpeg.geometry(coef, tdec.native_scale(coef.width, coef.height, 256))
        batch.append((coef, geo, w, h))
    plan = jpeg.DecodePlan(batch, "cpu")
    _check_upsample_layout(plan.color, plan.up)
    for d, (coef, geo, w, h) in zip(plan.up.desc, batch):
        rows = int(d[UP["rows"]])
        assert rows == h or jpeg._tile_bytes(rows + 1, w, len(geo), geo) > jpeg.UP_SMEM


@pytest.mark.parametrize("planes,out,match", [
    ([jpeg.Plane(0, 4, 4, 1, 1, 0)] * 2, (4, 4), "1 or 3 planes"),
    ([jpeg.Plane(0, 4, 4, 1, 1, 0)], (0, 4), "non-empty"),
    ([jpeg.Plane(0, 4, 4, 1, 2, 1)], (8, 8), "plane"),  # h2v1 at the factors of h1v2
    ([jpeg.Plane(0, 5, 4, 1, 1, 0)], (8, 8), "stride"),
])
def test_upsample_layout_refuses(planes, out, match):
    with pytest.raises(ValueError, match=match):
        jpeg.upsample_layout([([(0, 4, p) for p in planes], *out, False)])


def test_upsample_batched_plain_equals_per_image_on_the_fixtures():
    """One ``DecodePlan`` over every committed JPEG at every scale: each
    output, a view of the packed output, equals ``upsample_color_plain``
    of the image's ``idct_plain`` planes, bit for bit."""
    images = _fixture_images()
    plan = jpeg.DecodePlan(images, "cpu")
    staged = jpeg.stage("cpu", plan.tables())
    assert [t.dtype for t in staged] == [torch.int16, torch.int32, torch.int64, torch.int64]
    got = plan.run(staged)
    for img, (coef, geo, out_w, out_h) in zip(got, images):
        planes = [jpeg.idct_plain(c.coefs, c.quant, p.size) for c, p in zip(coef.components, geo)]
        want = jpeg.upsample_color_plain(planes, geo, out_w, out_h, coef.ycc)
        assert img.shape == want.shape and torch.equal(img, want)


def test_random_planes_cover_the_kernel_cases():
    """``random_color_images``' draws hold every method, planes of 1 to 3
    samples a side, odd output sizes, 1 and 3 planes, YCbCr and RGB."""
    _, images = jpeg.random_color_images(np.random.default_rng(0), 40)
    geo = [p for planes, *_ in images for *_, p in planes]
    assert {p.method for p in geo} == {0, 1, 2, 3}
    assert {p.width for p in geo} >= {1, 2, 3} and {p.height for p in geo} >= {1, 2, 3}
    assert any(w % 2 and h % 2 for _, w, h, _ in images)
    assert {len(planes) for planes, *_ in images} == {1, 3}
    assert {ycc for planes, _, _, ycc in images if len(planes) == 3} == {False, True}


@given(seed=st.integers(0, 2**31), n_images=st.integers(1, 8))
@SETTINGS
def test_upsample_batched_plain_equals_per_image_on_random_planes(seed, n_images):
    """Random planes at unaligned offsets and strides: the batched plain
    version equals ``upsample_color_plain`` image by image, bit for bit,
    and writes nothing but the outputs."""
    packed, images = jpeg.random_color_images(np.random.default_rng(seed), n_images)
    layout = jpeg.upsample_layout(images)
    _check_upsample_layout(images, layout)
    out = jpeg.upsample_color_batch(packed, torch.from_numpy(layout.desc), layout)
    assert out.shape == (layout.out_bytes,)
    covered = torch.zeros(layout.out_bytes, dtype=torch.bool)
    for img, (planes, out_w, out_h, ycc) in zip(layout.views(out), images):
        views = [packed[o:o + p.height * stride].view(p.height, stride) for o, stride, p in planes]
        want = jpeg.upsample_color_plain(views, [p for *_, p in planes], out_w, out_h, ycc)
        assert torch.equal(img, want)
    for off, h, w, n in layout.outputs:
        covered[off:off + h * w * n] = True
    assert not bool(out[~covered].any())


def test_decode_coefficients_is_one_plan():
    """``decode_coefficients`` equals the IDCT's and the upsample's plain
    versions in turn (a table of one image each)."""
    coef, geo, out_w, out_h = _fixture_images([2])[0]
    got = jpeg.decode_coefficients(coef, "cpu", 2)
    planes = [jpeg.idct_plain(c.coefs, c.quant, p.size) for c, p in zip(coef.components, geo)]
    assert torch.equal(got, jpeg.upsample_color_plain(planes, geo, out_w, out_h, coef.ycc))


# ---------------------------------------------------------------------------
# resize + crop
# ---------------------------------------------------------------------------


def _source(rng, h, w, ch):
    return torch.from_numpy(rng.integers(0, 256, (h, w, ch), np.uint8))


def _check_resize_layout(sources, resize_to, out_size, layout):
    desc = layout.desc
    assert desc.dtype == np.int64 and desc.shape == (len(sources), 15)
    cta = 0
    for i, (d, img) in enumerate(zip(desc, sources)):
        sh, sw, ch = img.shape
        rw, rh, left, top = tdec._geometry(sw, sh, resize_to, out_size)
        assert (d[RS["cta0"]], d[RS["src"]], d[RS["sw"]], d[RS["sh"]], d[RS["ch"]]) == (
            cta, img.data_ptr(), sw, sh, ch)
        assert (d[RS["left"]], d[RS["top"]]) == (left, top)
        # jcf_resize_crop's float(sw) / rw, bit for bit
        for key, num, den in (("sx", sw, rw), ("sy", sh, rh)):
            got = np.array([d[RS[key]]], np.int64).astype(np.int32).view(np.float32)[0]
            assert got == np.float32(num) / np.float32(den)
        assert d[RS["offset"]] == i * out_size * out_size * 3
        rows, cols, spans = (int(d[RS[k]]) for k in ("rows", "cols", "spans"))
        tx, ty = int(d[RS["tx"]]), int(d[RS["ty"]])
        assert 1 <= rows <= tdec.RS_ROWS and rows * ty <= tdec.RS_WY
        assert 1 <= cols <= tdec.RS_SPAN and cols * tx <= tdec.RS_WX
        assert (spans - 1) * cols < out_size <= spans * cols
        cta += -(-out_size // rows) * spans
    assert layout.ctas == cta


def _windows(in_size, out_size, first, n, fused):
    """``window``'s (lo, hi) for output coordinates first.., as
    ``csrc/jpeg.cu`` computes them in f32, its center with one rounding
    (``fused``, the FMA nvcc makes) or two."""
    f = np.float32
    scale = f(in_size) / f(out_size)
    support = max(scale, f(1.0))
    o = np.arange(first, first + n).astype(f) + f(0.5)
    center = (o.astype(np.float64) * scale - 0.5).astype(f) if fused else o * scale - f(0.5)
    lo = np.maximum(np.floor(center - support).astype(np.int64), 0)
    hi = np.minimum(np.ceil(center + support).astype(np.int64), in_size - 1)
    return lo, hi, scale


@given(in_size=st.integers(1, 20000), out_size=st.integers(1, 700), fused=st.booleans())
@SETTINGS
def test_resize_taps_hold_every_window(in_size, out_size, fused):
    """The taps the table reserves a window (``_taps``) hold every window
    of the scale, with the center rounded once or twice."""
    lo, hi, scale = _windows(in_size, out_size, 0, out_size, fused)
    assert int((hi - lo + 1).max()) <= tdec._taps(scale)


def test_resize_layout_of_mixed_sources():
    """JPEG-sized and PNG-sized sources, 1 and 3 channels, up- and
    downscales, three crops: every field as ``jcf_resize_crop`` computed it
    and every tile within the kernel's limits; a 2600-high source to 40
    takes spans narrower than the crop."""
    rng = np.random.default_rng(0)
    sources = [_source(rng, 240, 320, 3), _source(rng, 280, 300, 1), _source(rng, 1100, 1040, 3),
               _source(rng, 7, 13, 3), _source(rng, 2600, 3000, 3)]
    for resize_to, out_size in ((256, 256), (300, 224), (40, 40)):
        layout = tdec.resize_layout(sources, resize_to, out_size)
        _check_resize_layout(sources, resize_to, out_size, layout)
    assert layout.desc[-1, RS["spans"]] > 1
    assert tdec.resize_layout([], 256, 256).desc.shape == (0, 15)


@pytest.mark.parametrize("img,args,match", [
    (torch.zeros(8, 8, 2, dtype=torch.uint8), (8, 8), "1 or 3"),
    (torch.zeros(8, 8, 3), (8, 8), "uint8"),
    (torch.zeros(8, 8, 3, dtype=torch.uint8), (8, 9), "larger"),
    (torch.zeros(3000, 3000, 1, dtype=torch.uint8), (2, 2), "taps"),
])
def test_resize_layout_refuses(img, args, match):
    with pytest.raises(ValueError, match=match):
        tdec.resize_layout([img], *args)


@pytest.mark.parametrize("case", ["upscale", "png_4x_downscale", "crop_below_resize", "mixed"])
def test_resize_batched_plain_equals_per_image(case, tmp_path):
    """``resize_crop_batch`` on CPU tensors (its plain version) equals
    ``resize_crop_plain`` image by image, bit for bit."""
    rng = np.random.default_rng(1)
    if case == "upscale":  # short sides 240 and 250 to 256, support 1
        sources, resize_to, out_size = [_source(rng, 240, 320, 3), _source(rng, 333, 250, 3)], 256, 256
    elif case == "png_4x_downscale":  # a full-size PNG at 4x: support 4
        png = str(tmp_path / "big.png")
        Image.fromarray(rng.integers(0, 256, (1100, 1040, 3), np.uint8)).save(png)
        sources, resize_to, out_size = [tdec.decode_file(png, "cpu")], 260, 256
    elif case == "crop_below_resize":
        sources, resize_to, out_size = [_source(rng, 300, 280, 3)], 300, 224
    else:  # gray and color, up and down
        sources = [_source(rng, 97, 50, 1), _source(rng, 540, 720, 3), _source(rng, 280, 300, 1)]
        resize_to, out_size = 128, 112
    got = tdec.resize_crop_batch(sources, resize_to, out_size)
    assert got.shape == (len(sources), out_size, out_size, 3) and got.dtype == torch.uint8
    for g, img in zip(got, sources):
        assert torch.equal(g, tdec.resize_crop_plain(img, resize_to, out_size))
    assert torch.equal(tdec.resize_crop_batch_plain(sources, resize_to, out_size), got)


def test_decode_batch_on_the_cpu_takes_any_downscale(tmp_path):
    """A 3000 x 3000 PNG to a short side of 2 needs windows wider than the
    kernel's table holds (``resize_layout`` refuses it); on the CPU
    ``decode_batch`` runs the plain version, which takes it."""
    png = str(tmp_path / "big.png")
    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 256, (3000, 3000), np.uint8)).save(png)
    got = tdec.decode_batch([png], 2, 2, device="cpu", uint8=True)
    want = tdec.resize_crop_plain(tdec.decode_file(png, "cpu"), 2, 2)
    assert got.shape == (1, 2, 2, 3) and torch.equal(got[0], want)


def test_resize_crop_batch_of_nothing():
    out = tdec.resize_crop_batch([], 64, 32)
    assert out.shape == (0, 32, 32, 3) and out.dtype == torch.uint8
