"""The batched IDCT (``data.jpeg.idct_layout``, ``idct_batch_plain``,
``IdctLayout.run``) and ``decode_batch`` on it, on the CPU.

- The descriptor table: each component's first CTA, first block, grid,
  size, table and plane offset; block ranges padded to whole CTAs of
  ``IDCT_BLOCKS`` so no CTA serves two components; 16-byte aligned
  planes; mixed IDCT sizes in one table (at 1/2 on 4:2:0 the luma takes
  4 x 4 and the chroma 8 x 8); a grayscale file in a color batch; an empty
  batch.
- ``idct_batch_plain`` over one table of many images equals
  ``idct_plain`` component by component, bit for bit: every committed
  JPEG at every scale in one batch, and random coefficients past 16 bits
  with tables up to 65535 at mixed sizes.
- ``decode_batch`` equals the per-file decode (``decode_coefficients`` at
  ``native_scale``, then ``resize_crop``) byte for byte, PNGs and JPEGs
  mixed, and meets ``jcf_tpu.native``'s committed output within one level
  (the resize's f32 sums), as before.
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
FIELDS = {name: i for i, name in enumerate(jpeg.DESC_FIELDS)}


def _fixture_paths():
    """Every committed JPEG (the six fixtures and the four under
    ``extra/``), as absolute paths."""
    return [os.path.join(FIXTURES, p) for p in make_jpeg_hashes.fixture_paths()]


def _coefficients(path):
    with open(path, "rb") as f:
        return jpeg.read_coefficients(f.read(), path)


def _images(paths, scale):
    """(coefficients, geometry planes) of each file at 1/``scale``."""
    out = []
    for p in paths:
        coef = _coefficients(p)
        out.append((coef, jpeg.geometry(coef, scale, p)[2]))
    return out


def _per_component(images):
    """``idct_plain`` of each component of each image, in order."""
    return [[jpeg.idct_plain(c.coefs, c.quant, p.size) for c, p in zip(coef.components, geo)]
            for coef, geo in images]


def _batched(images):
    """One ``idct_batch`` over ``images`` through ``stage`` -> per image
    its planes, views of the packed output."""
    layout = jpeg.idct_layout(images)
    return layout.views(layout.run(jpeg.stage("cpu", layout.tables(images))))


def _check_layout(images, layout):
    """Every descriptor row against its component, the padding and the
    alignment."""
    desc = layout.desc
    assert desc.dtype == np.int64 and desc.shape == (sum(len(g) for _, g in images), 8)
    row = blk = cta = 0
    for (coef, geo), planes in zip(images, layout.planes):
        assert len(planes) == len(coef.components)
        for c, p, (off, h, w) in zip(coef.components, geo, planes):
            d = desc[row]
            n = c.blocks_w * c.blocks_h
            assert d[FIELDS["cta0"]] == cta and d[FIELDS["blk0"]] == blk
            assert (d[FIELDS["bw"]], d[FIELDS["bh"]], d[FIELDS["size"]]) == (c.blocks_w, c.blocks_h,
                                                                             p.size)
            assert d[FIELDS["table"]] == row and d[FIELDS["offset"]] == off
            assert d[FIELDS["stride"]] == w == c.blocks_w * p.size and h == c.blocks_h * p.size
            assert off % 16 == 0
            # no CTA straddles two components: this one's CTAs cover its
            # blocks, and the next component starts on a fresh CTA
            ctas = -(-n // jpeg.IDCT_BLOCKS)
            assert (ctas - 1) * jpeg.IDCT_BLOCKS < n <= ctas * jpeg.IDCT_BLOCKS
            row, blk, cta = row + 1, blk + n, cta + ctas
    assert (layout.blocks, layout.ctas) == (blk, cta)
    ends = [off + h * w for planes in layout.planes for off, h, w in planes]
    assert layout.out_bytes >= max(ends) and layout.out_bytes - max(ends) < 16
    starts = sorted(off for planes in layout.planes for off, _, _ in planes)
    assert all(b >= a for a, b in zip(ends, starts[1:]))


def test_layout_of_the_fixtures_at_every_scale():
    """All committed JPEGs (4:2:0, 4:4:4, grayscale, progressive, restart
    markers, 4:2:2, 13 x 7) at each scale, in one table; at 1/2 the 4:2:0
    files mix 4 x 4 (luma) and 8 x 8 (chroma) sizes in it."""
    paths = _fixture_paths()
    for scale in jpeg.SCALES:
        images = _images(paths, scale)
        layout = jpeg.idct_layout(images)
        _check_layout(images, layout)
        sizes = set(layout.desc[:, FIELDS["size"]].tolist())
        assert sizes == ({8} if scale == 1 else {8 // scale, 16 // scale})
    gray = [i for i, p in enumerate(paths) if "gray" in p]
    images = _images(paths, 2)
    layout = jpeg.idct_layout(images)
    assert gray and all(len(layout.planes[i]) == 1 for i in gray)
    assert all(len(layout.planes[i]) == 3 for i in range(len(paths)) if i not in gray)


def test_empty_batch():
    layout = jpeg.idct_layout([])
    assert layout.desc.shape == (0, 8) and layout.blocks == layout.ctas == layout.out_bytes == 0
    assert layout.planes == [] and layout.views(torch.zeros(0, dtype=torch.uint8)) == []
    out = tdec.decode_batch([], 64, 32, device="cpu", uint8=True)
    assert out.shape == (0, 32, 32, 3) and out.dtype == torch.uint8


@pytest.mark.parametrize("scale", jpeg.SCALES)
def test_batched_plain_equals_per_component_on_the_fixtures(scale):
    """One table over every committed JPEG (gray among color) at the scale:
    each plane, a view of the packed output, equals ``idct_plain`` of its
    component."""
    images = _images(_fixture_paths(), scale)
    for got, want in zip(_batched(images), _per_component(images)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8 and torch.equal(g, w)


@given(seed=st.integers(0, 2**31), table=st.sampled_from([1, 255, 65535]),
       n_images=st.integers(1, 4))
@SETTINGS
def test_batched_plain_equals_per_component_on_random_coefficients(seed, table, n_images):
    """Images of ``data.jpeg.random_idct_images``: 1 or 3 components with
    random grids (1 to 70 blocks a row, 1 to 8 rows, so ranges end
    mid-CTA) and random IDCT sizes mixed within an image and across
    images: the batched plain version equals
    ``idct_plain`` per component, bit for bit."""
    images = jpeg.random_idct_images(np.random.default_rng(seed), n_images, max_bw=70,
                                     table=table)
    layout = jpeg.idct_layout(images)
    _check_layout(images, layout)
    for got, want in zip(_batched(images), _per_component(images)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# decode_batch
# ---------------------------------------------------------------------------


def _per_file(paths, resize_to, out_size):
    """Each file decoded alone at ``native_scale`` and resized."""
    out = []
    for p in paths:
        data = open(p, "rb").read()
        if data.startswith(b"\xff\xd8"):
            coef = jpeg.read_coefficients(data, p)
            img = jpeg.decode_coefficients(coef, "cpu", tdec.native_scale(coef.width, coef.height,
                                                                            resize_to), name=p)
        else:
            img = tdec.decode_file(p, "cpu")
        out.append(tdec.resize_crop(img, resize_to, out_size))
    return torch.stack(out)


@pytest.mark.parametrize("resize_to,out_size", [(256, 256), (64, 48), (300, 224)])
def test_decode_batch_equals_the_per_file_decode(tmp_path, resize_to, out_size):
    """Every committed JPEG (the scales 1, 2, 4 and 8 among them at 64) and
    a PNG in one batch: byte for byte the files decoded one by one."""
    png = str(tmp_path / "p.png")
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (90, 70, 3), np.uint8)).save(png)
    paths = _fixture_paths()
    paths = paths[:3] + [png] + paths[3:]
    got = tdec.decode_batch(paths, resize_to, out_size, device="cpu", uint8=True)
    assert got.shape == (len(paths), out_size, out_size, 3)
    assert torch.equal(got, _per_file(paths, resize_to, out_size))
    if resize_to == 64:
        scales = {tdec.native_scale(*Image.open(p).size, 64) for p in paths}
        assert scales == {1, 2, 4, 8}


def test_decode_batch_meets_the_committed_native_output():
    """``decode_batch`` of the six fixtures within one level of
    ``jcf_tpu.native``'s output (``pil_256`` + ``delta``), on at most 0.1%
    of the values."""
    refs = np.load(os.path.join(FIXTURES, "native_minus_pil.npz"))
    names = [str(n) for n in refs["names"]]
    pil = np.stack([tdec.decode_png(open(os.path.join(FIXTURES, "pil_256", n[:-4] + ".png"),
                                         "rb").read()) for n in names])
    native = (pil.astype(np.int16) + refs["delta"]).astype(np.int16)
    got = tdec.decode_batch([os.path.join(FIXTURES, n) for n in names], device="cpu",
                            uint8=True).numpy().astype(np.int16)
    d = np.abs(got - native)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_decode_batch_refuses_other_files(tmp_path):
    other = tmp_path / "x.gif"
    other.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="x.gif"):
        tdec.decode_batch([os.path.join(FIXTURES, "f0_420_240x320.jpg"), str(other)],
                          device="cpu")
