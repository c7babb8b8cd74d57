"""The port's image decode (``jcf_tpu_torch.data.decode``) on the CPU
against the JAX package: ``decode_batch`` (the port's libjpeg-exact JPEG
decode at ``jcfnative``'s scale + its triangle resize and center crop)
against ``jcf_tpu.native.decode_batch`` (libjpeg + the C++ resize), the
PNG decoder against PIL, and the TestSetB walk against ``walk_test_dir``.

Bars: within 1 level and equal on at least 99.9% of the values, at full
size and at libjpeg's reduced scales alike (the decodes are byte-equal;
the resize's f32 sums run in another order than the C++ loop's, so a
value on a rounding tie can land one level off); the PNG decoder equal to
PIL's. ``tests/test_torch_jpeg_exact.py`` holds the decode itself to PIL
byte for byte."""

import os

import numpy as np
import pytest
from PIL import Image

import torch

from jcf_tpu.data import walk_test_dir as j_walk
from jcf_tpu.native import decode_batch as native_decode_batch
from jcf_tpu_torch.data import decode as tdec
from jcf_tpu_torch.data import read_image, walk_test_dir

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jpeg")


def _fixture_paths():
    return sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES) if f.endswith(".jpg"))


def _short_side(path):
    with Image.open(path) as img:
        return min(img.size)


def _native_u8(paths, resize_to=256, out_size=256):
    return np.round(native_decode_batch(paths, resize_to, out_size) * 255).astype(np.uint8)


def _seeded_jpegs(tmp_path):
    """JPEGs of several sizes and aspects below a 512 short side, 4:2:0,
    4:4:4 and grayscale."""
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w, mode, sub) in enumerate([(257, 300, "RGB", 2), (300, 256, "RGB", 0),
                                           (480, 640, "RGB", 2), (511, 400, "L", None),
                                           (260, 1000, "RGB", 2), (333, 333, "RGB", 0)]):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx * yy) % 256], -1)
        img = np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)
        pil = Image.fromarray(img).convert(mode)
        path = str(tmp_path / f"img_{i}.jpg")
        pil.save(path, quality=90, **({} if sub is None else {"subsampling": sub}))
        paths.append(path)
    return paths


def _within_one_level(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


def test_decode_batch_matches_native_below_512(tmp_path):
    paths = _seeded_jpegs(tmp_path) + [p for p in _fixture_paths() if _short_side(p) < 512]
    assert len(paths) == 9
    got = tdec.decode_batch(paths, 256, 256, device="cpu", uint8=True).numpy()
    _within_one_level(got, _native_u8(paths).transpose(0, 2, 3, 1))
    # the float output is the uint8 one / 255, channels first, as JAX returns it
    f = tdec.decode_batch(paths[:2], 256, 256, device="cpu")
    assert f.dtype == torch.float32 and f.shape == (2, 3, 256, 256)
    np.testing.assert_array_equal(f.numpy(),
                                  got[:2].transpose(0, 3, 1, 2).astype(np.float32) / 255.0)


@pytest.mark.parametrize("resize_to,out_size", [(256, 224), (288, 288), (250, 128)])
def test_other_sizes_match_native(tmp_path, resize_to, out_size):
    """Other sizes, each below half the short sides (no reduced-scale
    decode in libjpeg)."""
    paths = _seeded_jpegs(tmp_path)[:3]
    got = tdec.decode_batch(paths, resize_to, out_size, device="cpu", uint8=True).numpy()
    _within_one_level(got, _native_u8(paths, resize_to, out_size).transpose(0, 2, 3, 1))


def test_reduced_scale_difference_on_the_fixtures():
    """From a 512 short side libjpeg decodes at 1/2 or 1/4 scale, and so
    does the port (``native_scale``): the outputs agree within the resize's
    rounding, as below 512."""
    paths = [p for p in _fixture_paths() if _short_side(p) >= 512]
    assert len(paths) == 3
    assert [tdec.native_scale(*Image.open(p).size, 256) for p in paths] == [2, 2, 4]
    got = tdec.decode_batch(paths, 256, 256, device="cpu", uint8=True).numpy()
    _within_one_level(got, _native_u8(paths).transpose(0, 2, 3, 1))


def test_committed_references_are_current():
    """The references ``chip_smoke.py`` holds the card's decode + resize
    to are what the CPU gives today: ``pil_256`` is the full-size decode
    (PIL's) through the resize and crop, byte for byte; ``pil_256`` +
    ``delta`` is ``jcf_tpu.native``'s output, which ``decode_batch`` (at
    libjpeg's scale) meets within one level."""
    refs = np.load(os.path.join(FIXTURES, "native_minus_pil.npz"))
    names = [str(n) for n in refs["names"]]
    paths = [os.path.join(FIXTURES, n) for n in names]
    assert sorted(paths) == _fixture_paths()
    pil = np.stack([tdec.decode_png(open(os.path.join(FIXTURES, "pil_256", n[:-4] + ".png"),
                                         "rb").read()) for n in names])
    full = np.stack([tdec.resize_crop(tdec.decode_file(p, "cpu"), 256, 256).numpy()
                     for p in paths])
    np.testing.assert_array_equal(full, pil)
    native = pil.astype(np.int16) + refs["delta"]
    np.testing.assert_array_equal(native, _native_u8(paths).transpose(0, 2, 3, 1))
    _within_one_level(tdec.decode_batch(paths, device="cpu", uint8=True).numpy(),
                      native.astype(np.uint8))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_decoder_equals_pil(tmp_path, mode, optimize):
    rng = np.random.default_rng(1)
    h, w = 37, 53
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 4) % 256, (yy * 6) % 256, (xx + yy) % 256, (xx * yy) % 256], -1)
    img = np.where(rng.random((h, w, 1)) < 0.2, rng.integers(0, 256, (h, w, 4)), base)
    pil = Image.fromarray(img.astype(np.uint8), "RGBA").convert(mode)
    path = str(tmp_path / f"x_{mode}.png")
    pil.save(path, optimize=optimize)
    got = tdec.decode_file(path, "cpu")
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(Image.open(path).convert("RGB")))


def test_unsupported_files_raise_and_name_themselves(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (8, 9, 3)).astype(np.uint8)
    cases = {"palette.png": lambda p: Image.fromarray(img).convert("P").save(p),
             "deep.png": lambda p: Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(p),
             "interlaced.png": lambda p: Image.fromarray(img).save(p, interlace=1),
             "text.jpg": lambda p: open(p, "w").write("not an image")}
    for name, write in cases.items():
        path = str(tmp_path / name)
        write(path)
        if name == "interlaced.png" and not (open(path, "rb").read()[28] == 1):
            continue  # this Pillow writes no interlaced PNG
        with pytest.raises(ValueError, match=name):
            tdec.decode_file(path, "cpu")
    with pytest.raises(IOError):
        tdec.decode_batch([str(tmp_path / "missing.jpg")], device="cpu")


def test_grayscale_jpeg_reads_as_rgb(tmp_path):
    path = [p for p in _fixture_paths() if "gray" in p][0]
    got = read_image(path, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_walk_order_and_macosx_match_jax(tmp_path):
    root = tmp_path / "TestSetB"
    for rel in ["b/z.jpg", "b/A.JPEG", "a/x.png", "a/y.jpg", "a/readme.txt", "__MACOSX/a/y.jpg",
                "c/__MACOSX_copy/q.jpg", "c/d/e.Png", "c/d/f.gif", "top.jpg"]:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")
    got = [(d.impath, d.label, d.classname, d.domain) for d in walk_test_dir(str(root))]
    want = [(d.impath, d.label, d.classname, d.domain) for d in j_walk(str(root))]
    assert got == want
    assert [os.path.relpath(p, root) for p, *_ in got] == [
        "top.jpg", "a/x.png", "a/y.jpg", "b/A.JPEG", "b/z.jpg", "c/d/e.Png"]
