"""K1: fused TTA view sampling (``jcf_tpu/ops/view_kernel.py``).

``fused_views_nchw`` resamples each image's crop views (triangle-filter
bilinear with antialiasing, flips folded into mirrored column centers)
and emits int8 pixels ``round(v * 254 - 127)`` for the int8 patch embed
(the JAX function with ``quantize=True``). On a CUDA tensor it launches
the hand-written kernel in ``csrc/view.cu``; on a CPU tensor it runs
``fused_views_nchw_plain``, which also gives the float views of the f32
reference path.

``sample_view_centers`` draws the crop geometry with a ``torch.Generator``
(the same box distribution as the JAX sampler; the random numbers differ,
so tests feed both sides the same geometry).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from jcf_tpu_torch import _build

# launches of the view kernel (fused_views_nchw on CUDA tensors)
LAUNCHES = {"view": 0}
# random crops: area share of the source and aspect range (the reference's)
CROP_SCALE = (0.5, 1.0)
CROP_RATIO = (0.75, 4.0 / 3.0)


def _triangle(centers, inv, n_src, transposed):
    """Normalized triangle weights for centers [..., out] -> [..., out, n_src]
    (or [..., n_src, out] transposed), f32, reference formula and order."""
    i = torch.arange(n_src, dtype=torch.float32, device=centers.device)
    if transposed:
        w = torch.clamp_min(1.0 - (centers[..., None, :] - i[:, None]).abs() * inv[..., None, None], 0.0)
        denom = torch.clamp_min(w.sum(dim=-2, keepdim=True), 1e-8)
    else:
        w = torch.clamp_min(1.0 - (centers[..., :, None] - i[None, :]).abs() * inv[..., None, None], 0.0)
        denom = torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-8)
    return w * (1.0 / denom)


def fused_views_nchw_plain(images, cy, cx, inv, out_size: int, *, quantize: bool = False):
    """Plain version of K1. images [B, C, H, W]; cy, cx [B, V, out] f32;
    inv [B, V, 2] f32 -> [B, V, C, out, out] in images.dtype, or int8 with
    ``quantize``. Weights and the row-resampled intermediate are cast to
    images.dtype; both products accumulate in f32."""
    b, c, h, w = images.shape
    dt = images.dtype
    wy = _triangle(cy, inv[..., 0], h, False).to(dt).float()  # [B, V, out, H]
    wxt = _triangle(cx, inv[..., 1], w, True).to(dt).float()  # [B, V, W, out]
    x = images.float()
    views = []
    for v in range(cy.shape[1]):
        t = torch.matmul(wy[:, v, None], x).to(dt).float()  # [B, C, out, W]
        views.append(torch.matmul(t, wxt[:, v, None]))      # [B, C, out, out]
    view = torch.stack(views, dim=1)
    if quantize:
        return torch.clamp(torch.round(view * 254.0 - 127.0), -127, 127).to(torch.int8)
    return view.to(dt)


def fused_views_nchw(images, cy, cx, inv, out_size: int):
    """K1 wrapper -> int8 views [B, V, C, out, out]: the CUDA kernel for
    CUDA tensors (bf16 images), the plain version for CPU tensors."""
    if not images.is_cuda:
        return fused_views_nchw_plain(images, cy, cx, inv, out_size, quantize=True)
    b, c, h, w = images.shape
    n_views = cy.shape[1]
    if images.dtype != torch.bfloat16:
        raise TypeError(f"view kernel takes bf16 images, got {images.dtype}")
    for name, t, shape in (("cy", cy, (b, n_views, out_size)),
                           ("cx", cx, (b, n_views, out_size)),
                           ("inv", inv, (b, n_views, 2))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != images.device:
            raise ValueError(f"{name} must be f32 {shape} on {images.device}")
    if w > 768:
        raise ValueError(f"view kernel supports source width <= 768, got {w}")
    images, cy, cx, inv = (t.contiguous() for t in (images, cy, cx, inv))
    out = torch.empty((b, n_views, c, out_size, out_size), dtype=torch.int8, device=images.device)
    lib = _build.load()
    err = lib.jcf_view(images.data_ptr(), cy.data_ptr(), cx.data_ptr(), inv.data_ptr(),
                       out.data_ptr(), b, c, h, w, n_views, out_size,
                       _build.stream_ptr(images.device))
    _build.check(err, "view")
    LAUNCHES["view"] += 1
    return out


def view_centers_from_boxes(boxes, flips, out_size: int):
    """Boxes [B, V, 4] = (top, left, h, w) and flips [B, V] bool ->
    (cy, cx [B, V, out], inv [B, V, 2]): per-output-pixel source centers
    and inverse triangle supports, a flip folded into reversed columns."""
    top, left, hh, ww = boxes.unbind(-1)
    o = torch.arange(out_size, dtype=torch.float32, device=boxes.device)
    cy = top[..., None] + (o + 0.5) * (hh / out_size)[..., None] - 0.5
    cx = left[..., None] + (o + 0.5) * (ww / out_size)[..., None] - 0.5
    cx = torch.where(flips[..., None], cx.flip(-1), cx)
    inv = torch.stack(
        [1.0 / torch.clamp_min(hh / out_size, 1.0), 1.0 / torch.clamp_min(ww / out_size, 1.0)],
        dim=-1,
    )
    return cy, cx, inv


def sample_tta_boxes(generator: torch.Generator, batch: int, n_random: int,
                     src_hw: Tuple[int, int], out_size: int):
    """Whole-batch TTA boxes: the center crop first, then ``n_random``
    random crops per image (area uniform in ``CROP_SCALE``, log-uniform aspect,
    clamped to the image; flip with probability 1/2) ->
    (boxes [B, 1+n, 4] f32, flips [B, 1+n] bool) on the generator's device."""
    h_src, w_src = src_hw
    dev = generator.device
    shape = (batch, n_random)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    area = (w_src * h_src) * uniform(*CROP_SCALE)
    aspect = torch.exp(uniform(math.log(CROP_RATIO[0]), math.log(CROP_RATIO[1])))
    w = torch.clamp(torch.sqrt(area * aspect), 8.0, w_src)
    h = torch.clamp(torch.sqrt(area / aspect), 8.0, h_src)
    top = uniform(0.0, 1.0) * (h_src - h)
    left = uniform(0.0, 1.0) * (w_src - w)
    flips = torch.rand(shape, generator=generator, device=dev) < 0.5
    boxes = torch.stack([top, left, h, w], dim=-1)
    center = torch.tensor(
        [(h_src - out_size) // 2, (w_src - out_size) // 2, out_size, out_size],
        dtype=torch.float32, device=dev,
    )
    boxes = torch.cat([center.expand(batch, 1, 4), boxes], dim=1)
    flips = torch.cat([torch.zeros(batch, 1, dtype=torch.bool, device=dev), flips], dim=1)
    return boxes, flips


def sample_view_centers(generator: torch.Generator, batch: int, n_views: int,
                        src_hw: Tuple[int, int], out_size: int):
    """Per-view centers and inverse supports for ``n_views`` views per
    image, the center crop as view 0 -> (cy, cx, inv)."""
    boxes, flips = sample_tta_boxes(generator, batch, n_views - 1, src_hw, out_size)
    return view_centers_from_boxes(boxes, flips, out_size)
