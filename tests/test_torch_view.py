"""K1, the view kernel's plain version, vs the JAX Pallas kernel in
interpret mode, on the same crop geometry: f32 views atol 2e-5; int8
views |diff| <= 1 on at most 0.5% of pixels (f32 sums in another order
can move a value across a rounding boundary). The centers built from
boxes are equal, and the torch sampler keeps the reference's layout
(center view first, flips mirrored)."""

import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jcf_tpu.infer.engine import sample_tta_boxes as j_sample_tta_boxes
from jcf_tpu.ops.view_kernel import fused_views_nchw as j_fused_views
from jcf_tpu.ops.view_kernel import sample_view_centers as j_sample_view_centers
from jcf_tpu_torch.ops import view_kernel as tv

torch.set_num_threads(1)

B, C, SRC, OUT, VIEWS = 4, 3, 72, 64, 4


def _inputs(seed):
    images = np.random.default_rng(seed).random((B, C, SRC, SRC)).astype(np.float32)
    cy, cx, inv = (np.array(a) for a in j_sample_view_centers(
        jax.random.PRNGKey(seed), B, VIEWS, (SRC, SRC), OUT))
    return images, cy, cx, inv


@pytest.mark.parametrize("seed", [0, 1])
def test_centers_from_boxes_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    boxes, flips = j_sample_tta_boxes(key, B, VIEWS - 1, (SRC, SRC), OUT)
    ref = j_sample_view_centers(key, B, VIEWS, (SRC, SRC), OUT)
    got = tv.view_centers_from_boxes(torch.from_numpy(np.array(boxes)),
                                     torch.from_numpy(np.array(flips)), OUT)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_views_f32_match_jax(seed):
    images, cy, cx, inv = _inputs(seed)
    ref = np.asarray(j_fused_views(jnp.asarray(images), jnp.asarray(cy), jnp.asarray(cx),
                                   jnp.asarray(inv), OUT, interpret=True))
    got = tv.fused_views_nchw_plain(torch.from_numpy(images), torch.from_numpy(cy),
                                    torch.from_numpy(cx), torch.from_numpy(inv), OUT)
    assert got.shape == (B, VIEWS, C, OUT, OUT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_views_int8_match_jax(seed):
    images, cy, cx, inv = _inputs(seed)
    img_bf = jnp.asarray(images).astype(jnp.bfloat16)
    ref = np.asarray(j_fused_views(img_bf, jnp.asarray(cy), jnp.asarray(cx), jnp.asarray(inv),
                                   OUT, interpret=True, quantize=True))
    got = tv.fused_views_nchw(torch.from_numpy(images).bfloat16(), torch.from_numpy(cy),
                              torch.from_numpy(cx), torch.from_numpy(inv), OUT)
    assert got.dtype == torch.int8 and ref.dtype == np.int8
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 5e-3, (d > 0).mean()


def test_torch_sampler_layout():
    """Center crop first (the exact center window), random boxes inside
    the image, a flip mirrors the column centers."""
    gen = torch.Generator().manual_seed(3)
    boxes, flips = tv.sample_tta_boxes(gen, 64, VIEWS - 1, (SRC, SRC), OUT)
    assert boxes.shape == (64, VIEWS, 4) and flips.shape == (64, VIEWS)
    off = (SRC - OUT) // 2
    np.testing.assert_array_equal(boxes[:, 0].numpy(), np.tile([off, off, OUT, OUT], (64, 1)))
    assert not flips[:, 0].any() and flips[:, 1:].any() and not flips[:, 1:].all()
    top, left, h, w = boxes[:, 1:].unbind(-1)
    assert bool((top >= 0).all() and (left >= 0).all())
    assert bool((top + h <= SRC + 1e-4).all() and (left + w <= SRC + 1e-4).all())
    area = h * w / (SRC * SRC)
    assert float(area.min()) >= 0.5 - 1e-3 and float(area.max()) <= 1.0 + 1e-3

    cy, cx, inv = tv.view_centers_from_boxes(boxes, flips, OUT)
    flipped = torch.where(flips[..., None], cx.flip(-1), cx)
    unflipped = tv.view_centers_from_boxes(boxes, torch.zeros_like(flips), OUT)[1]
    np.testing.assert_array_equal(flipped.numpy(), unflipped.numpy())
    assert bool((inv > 0).all() and (inv <= 1).all())

    # view 0 resamples to exactly the center window
    images = torch.rand(64, C, SRC, SRC, generator=gen)
    views = tv.fused_views_nchw_plain(images, cy, cx, inv, OUT)
    np.testing.assert_allclose(views[:, 0].numpy(),
                               images[:, :, off:off + OUT, off:off + OUT].numpy(), atol=2e-5)


def test_geometry_is_seeded():
    a = tv.sample_view_centers(torch.Generator().manual_seed(5), 2, VIEWS, (SRC, SRC), OUT)
    b = tv.sample_view_centers(torch.Generator().manual_seed(5), 2, VIEWS, (SRC, SRC), OUT)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_crop_ranges_are_the_reference_defaults():
    params = inspect.signature(j_sample_tta_boxes).parameters
    assert tv.CROP_SCALE == params["scale"].default
    assert tv.CROP_RATIO == params["ratio"].default
