"""K1: fused TTA view sampling (``jcf_tpu/ops/view_kernel.py``).

``fused_views_nchw`` resamples each image's crop views (triangle-filter
bilinear with antialiasing, flips folded into mirrored column centers)
and emits int8 pixels ``round(v * 254 - 127)`` for the int8 patch embed
(``quantize=True``), or the views in the images' dtype, bf16 or f32 (the
float engines'). With ``patch=p`` the int8 pixels come as the patch
embed's im2col rows (``models.clip._patchify``'s layout, the JAX
kernel's ``py_split`` emission), which the int8 GEMM reads as they are.
On a CUDA tensor it launches the hand-written kernel in ``csrc/view.cu``;
on a CPU tensor it runs ``fused_views_nchw_plain``.

``sample_view_centers`` draws the crop geometry with a ``torch.Generator``
(the same box distribution as the JAX sampler; the random numbers differ,
so tests feed both sides the same geometry).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.models.clip import _patchify

# launches of the view kernel (fused_views_nchw on CUDA tensors): int8
# pixels, bf16 and f32 views; the int8 pixels emitted as patch rows also
# as "view/patch"
LAUNCHES = {"view": 0, "view_bf16": 0, "view_f32": 0, "view/patch": 0}
# the kernel's modes by (image dtype, quantize) -> (C entry mode, count)
_MODES = {(torch.bfloat16, True): (0, "view"), (torch.bfloat16, False): (1, "view_bf16"),
          (torch.float32, False): (2, "view_f32")}
# random crops: area share of the source (the default; ``TTAEngine``'s
# ``crop_scale``) and aspect range (the reference's)
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


def fused_views_nchw_plain(images, cy, cx, inv, out_size: int, *, quantize: bool = False,
                           patch: Optional[int] = None):
    """Plain version of K1. images [B, C, H, W]; cy, cx [B, V, out] f32;
    inv [B, V, 2] f32 -> [B, V, C, out, out] in images.dtype, or int8 with
    ``quantize``. Weights and the row-resampled intermediate are cast to
    images.dtype; both products accumulate in f32. ``patch=p``: those
    views as patch rows [B * V * G², C * p * p] (``_patchify``)."""
    if patch is not None:
        views = fused_views_nchw_plain(images, cy, cx, inv, out_size, quantize=quantize)
        b, v, c = views.shape[:3]
        return _patchify(views.reshape(b * v, c, out_size, out_size), patch).reshape(
            -1, c * patch * patch)
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


def fused_views_nchw(images, cy, cx, inv, out_size: int, *, quantize: bool = False,
                     patch: Optional[int] = None):
    """K1 wrapper -> views [B, V, C, out, out]: int8 pixels with
    ``quantize`` (bf16 images), else in the images' dtype (bf16 or f32).
    ``patch=p`` (with ``quantize``; ``out`` a multiple of p): the int8
    pixels as the patch embed's rows [B * V * G², C * p * p], G = out / p,
    in ``_patchify``'s (c, py, px) order. The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if patch is not None and (not quantize or patch < 1 or out_size % patch):
        raise ValueError(f"patch rows take int8 pixels and a view side {out_size} that is a "
                         f"multiple of the patch, got patch={patch} with quantize={quantize}")
    if not images.is_cuda:
        return fused_views_nchw_plain(images, cy, cx, inv, out_size, quantize=quantize,
                                      patch=patch)
    b, c, h, w = images.shape
    n_views = cy.shape[1]
    if (images.dtype, quantize) not in _MODES:
        raise TypeError(f"view kernel takes bf16 images (int8 or bf16 views) or f32 images (f32 "
                        f"views), got {images.dtype} with quantize={quantize}")
    mode, name = _MODES[(images.dtype, quantize)]
    for arg, t, shape in (("cy", cy, (b, n_views, out_size)),
                          ("cx", cx, (b, n_views, out_size)),
                          ("inv", inv, (b, n_views, 2))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != images.device:
            raise ValueError(f"{arg} must be f32 {shape} on {images.device}")
    if w > 768:
        raise ValueError(f"view kernel supports source width <= 768, got {w}")
    images, cy, cx, inv = (t.contiguous() for t in (images, cy, cx, inv))
    shape = ((b, n_views, c, out_size, out_size) if patch is None
             else (b * n_views * (out_size // patch) ** 2, c * patch * patch))
    out = torch.empty(shape, dtype=torch.int8 if quantize else images.dtype, device=images.device)
    lib = _build.load()
    err = lib.jcf_view(images.data_ptr(), cy.data_ptr(), cx.data_ptr(), inv.data_ptr(),
                       out.data_ptr(), b, c, h, w, n_views, out_size, mode, patch or 0,
                       _build.stream_ptr(images.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    if patch is not None:
        LAUNCHES["view/patch"] += 1
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
                     src_hw: Tuple[int, int], out_size: int,
                     scale: Tuple[float, float] = CROP_SCALE):
    """Whole-batch TTA boxes: the center crop first, then ``n_random``
    random crops per image (area uniform in ``scale``, log-uniform aspect,
    clamped to the image; flip with probability 1/2) ->
    (boxes [B, 1+n, 4] f32, flips [B, 1+n] bool) on the generator's device."""
    h_src, w_src = src_hw
    dev = generator.device
    shape = (batch, n_random)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    area = (w_src * h_src) * uniform(*scale)
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
                        src_hw: Tuple[int, int], out_size: int,
                        scale: Tuple[float, float] = CROP_SCALE):
    """Per-view centers and inverse supports for ``n_views`` views per
    image, the center crop as view 0 -> (cy, cx, inv); the random views'
    areas are uniform in ``scale`` of the source's."""
    boxes, flips = sample_tta_boxes(generator, batch, n_views - 1, src_hw, out_size, scale)
    return view_centers_from_boxes(boxes, flips, out_size)
