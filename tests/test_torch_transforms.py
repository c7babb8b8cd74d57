"""The port's PIL-free transforms (``jcf_tpu_torch.data.transforms``)
against ``jcf_tpu.data.transforms`` (PIL 12.1) on seeded uint8 images of
several sizes and aspects, upscaling and downscaling.

Bar: equality. The port reproduces Pillow's fixed-point separable
resample with exact float64 sums, so every resized pixel, every crop box
and flip, and every float32 view equals the JAX package's."""

import numpy as np
import pytest
from PIL import Image

import torch

from jcf_tpu.data import transforms as jt
from jcf_tpu_torch.data import transforms as tt

torch.set_num_threads(1)

# (height, width): small, square, tall, wide, odd, and larger than the targets
SHAPES = [(40, 44), (31, 17), (224, 224), (97, 513), (300, 200), (480, 640), (1000, 333)]
# (width, height) targets: up and down in each direction, one axis kept
TARGETS = [(224, 224), (17, 300), (512, 91), (96, 96)]


def _image(seed, h, w):
    """Seeded content with both smooth ramps and noise, so that rounding
    and clipping (bicubic overshoot) both occur."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = np.stack([(xx * 255) // max(w - 1, 1), (yy * 255) // max(h - 1, 1),
                     ((xx + yy) * 7) % 256], -1)
    noise = rng.integers(0, 256, (h, w, 3))
    return np.where(rng.random((h, w, 1)) < 0.3, noise, ramp).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
def test_resample_equals_pil(shape, kind):
    h, w = shape
    img = _image(h * 7 + w, h, w)
    mode = Image.BILINEAR if kind == "bilinear" else Image.BICUBIC
    for size in TARGETS + [(w, 77), (3 * w // 2, h)]:
        want = np.asarray(Image.fromarray(img).resize(size, mode))
        got = tt.resample(torch.from_numpy(img), size, kind).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{shape} -> {size} {kind}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("size", [224, 256, 64])
def test_resize_short_side_and_center_equal_pil(shape, size):
    h, w = shape
    img = _image(h + w, h, w)
    want = np.asarray(jt.resize_short_side(Image.fromarray(img), size))
    got = tt.resize_short_side(torch.from_numpy(img), size).numpy()
    np.testing.assert_array_equal(got, want)
    crop = min(size, 224)
    for norm in (True, False):
        want_c = jt.preprocess_center(Image.fromarray(img), size=crop, resize_to=size,
                                      apply_normalize=norm)
        got_c = tt.preprocess_center(torch.from_numpy(img), size=crop, resize_to=size,
                                     apply_normalize=norm)
        assert got_c.dtype == torch.float32 and got_c.shape == (3, crop, crop)
        np.testing.assert_array_equal(got_c.numpy(), want_c)


@pytest.mark.parametrize("wh", [(44, 40), (640, 480), (1000, 12), (9, 700), (224, 224), (1, 1)])
@pytest.mark.parametrize("scale", [(0.5, 1.0), (0.05, 1.0)])
def test_sample_params_equal_boxes(wh, scale):
    """Equal boxes draw for draw, the fallback branch included (a 1000 x
    12 or 9 x 700 image: no 3/4-4/3 aspect fits in ten attempts)."""
    width, height = wh
    jc, tc = jt.RandomResizedCrop(scale=scale), tt.RandomResizedCrop(scale=scale)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    boxes = [tc.sample_params(width, height, tr) for _ in range(200)]
    assert boxes == [jc.sample_params(width, height, jr) for _ in range(200)]
    assert jr.random() == tr.random()  # the same number of draws
    if width / height > 4 / 3 or width / height < 3 / 4:
        fallback = ((height - round(width / (3 / 4))) // 2 if width / height < 3 / 4 else 0)
        assert any(b[0] == fallback for b in boxes)


@pytest.mark.parametrize("shape", [(40, 44), (97, 513), (480, 640)])
def test_random_resized_crop_equals_pil(shape):
    h, w = shape
    img = _image(3 * h + w, h, w)
    jc, tc = jt.RandomResizedCrop(size=56), tt.RandomResizedCrop(size=56)
    jr, tr = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(12):
        want = np.asarray(jc(Image.fromarray(img), jr))
        got = tc(torch.from_numpy(img), tr).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(40, 44), (300, 200), (97, 513)])
@pytest.mark.parametrize("normalize", [True, False])
def test_tta_crop_sampler_equals_jax(shape, normalize):
    """``TTACropSampler(seed, index)``: the same boxes, flips and views,
    float32-equal, for several image indices."""
    h, w = shape
    img = _image(h * w, h, w)
    js = jt.TTACropSampler(n_views=9, size=48, apply_normalize=normalize, seed=3)
    ts = tt.TTACropSampler(n_views=9, size=48, apply_normalize=normalize, seed=3)
    for index in (0, 7):
        want = js(Image.fromarray(img), index)
        got = ts(torch.from_numpy(img), index)
        assert got.dtype == torch.float32 and got.shape == (9, 3, 48, 48)
        np.testing.assert_array_equal(got.numpy(), want)


def test_chw_and_normalize_equal_jax():
    img = _image(0, 20, 30)
    arr = tt.to_chw_array(torch.from_numpy(img))
    np.testing.assert_array_equal(arr.numpy(), jt.to_chw_array(Image.fromarray(img)))
    np.testing.assert_array_equal(tt.normalize(arr).numpy(), jt.normalize(arr.numpy()))
    assert tt.CLIP_MEAN == jt.CLIP_MEAN and tt.CLIP_STD == jt.CLIP_STD
