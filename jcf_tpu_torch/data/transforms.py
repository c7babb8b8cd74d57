"""Host-side preprocessing of ``jcf_tpu/data/transforms.py`` without PIL:
torch functions on uint8 [H, W, 3] tensors, on whatever device the image
lies (the card on ``jcf-ood``'s parity path, the CPU in the tests).

The JAX package resamples with PIL. PIL's resample is reproduced here as
Pillow computes it (``libImaging/Resample.c``) for 8-bit images:

- per output coordinate, in float64: ``scale = in / out``, the support
  ``filter_support * max(scale, 1)``, the window ``[int(center - support
  + 0.5), int(center + support + 0.5))`` clamped to the image (``center =
  (x + 0.5) * scale``), weights ``filter((i - center + 0.5) / max(scale,
  1))`` normalized by their sum in tap order;
- the weights turned into 22-bit fixed point (``int(w * 2^22 +- 0.5)``);
- the horizontal pass over the rows the vertical pass reads, each output
  ``clip8((2^21 + sum pixel * weight) >> 22)``, then the vertical pass on
  that uint8 intermediate; a pass whose size does not change is skipped.

Each pass is one float64 matmul of the uint8 values with the integer
weight matrix: every product and partial sum is an integer below 2^53,
so the sums are exact in any order, on the card as on the CPU, and the
results equal PIL 12.1's bit for bit (``tests/test_torch_transforms.py``).
The TTA views of one image go through together (``resample_boxes``):
a chunk of crops is one gather and two batched matmuls.

Randomness stays in numpy: ``RandomResizedCrop.sample_params`` and
``TTACropSampler`` draw from ``numpy.random.Generator`` draw for draw as
the JAX classes do, so the same seed gives the same boxes and flips.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from jcf_tpu_torch.ops.quant import true_div

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# ImageNet statistics of the MoCo ResNet-50's input (slow_pace.py:1274)
MOCO_MEAN = (0.485, 0.456, 0.406)
MOCO_STD = (0.229, 0.224, 0.225)

_PRECISION_BITS = 22  # 32 - 8 - 2, Pillow's fixed point for 8-bit images


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coefficients(in_sizes: np.ndarray, out_size: int, kind: str):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for boxes
    (0, in_size) of each in ``in_sizes`` -> (the fixed-point weights
    [N, out_size, taps] as float64 integers, zero past each window; the
    windows' first input index [N, out_size])."""
    filt, base_support = FILTERS[kind]
    in_sizes = np.asarray(in_sizes, np.int64)
    scale = in_sizes / out_size
    filterscale = np.maximum(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support.max())) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5)[None, :] * scale[:, None]
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support[:, None] + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support[:, None] + 0.5).astype(np.int64),
                      in_sizes[:, None]) - xmin
    taps = np.arange(ksize)
    live = taps < xmax[..., None]
    k = np.where(live, filt(((taps + xmin[..., None]) - center[..., None] + 0.5)
                            * ss[:, None, None]), 0.0)
    ww = np.zeros(xmin.shape)
    for t in range(ksize):  # the sum in tap order
        ww = ww + k[..., t]
    k = np.where((ww != 0.0)[..., None], k / np.where(ww != 0.0, ww, 1.0)[..., None], k)
    fixed = np.trunc(np.where(k < 0, -0.5 + k * (1 << _PRECISION_BITS),
                              0.5 + k * (1 << _PRECISION_BITS)))
    return fixed, xmin


def _dense(fixed: np.ndarray, start: np.ndarray, width: int, dev) -> torch.Tensor:
    """The weights of ``_coefficients`` as dense float64 matrices [N, out,
    width] on ``dev`` (a tap past the window carries 0)."""
    idx = np.minimum(start[..., None] + np.arange(fixed.shape[-1]), width - 1)
    dense = torch.zeros((*fixed.shape[:2], width), dtype=torch.float64, device=dev)
    return dense.scatter_add_(2, torch.from_numpy(idx).to(dev), torch.from_numpy(fixed).to(dev))


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    """Pillow's clip8 of (2^21 + acc): the sum >> 22, clamped to [0, 255]."""
    v = torch.floor((acc + float(1 << (_PRECISION_BITS - 1))) / float(1 << _PRECISION_BITS))
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


# elements (float64) of one chunk's padded crop stack
_CHUNK_ELEMS = 1 << 26


def resample_boxes(img: torch.Tensor, boxes, size: Tuple[int, int],
                   kind: str = "bilinear") -> torch.Tensor:
    """``PIL.Image.crop(box).resize(size, BILINEAR | BICUBIC)`` for each
    box (top, left, h, w) of an RGB image: uint8 [H, W, 3] -> uint8 [N, h',
    w', 3] for ``size = (w', h')``, on the image's device.

    The crops go through in chunks: each chunk's boxes gathered into one
    padded stack, each pass one batched float64 matmul with the boxes'
    weight matrices (zero past a box's edge, so the padding adds exact
    zeros). A pass whose size does not change has identity weights (2^22
    on the diagonal), which leave every pixel as it is, as PIL's skipped
    pass does."""
    out_w, out_h = size
    height, width = img.shape[:2]
    dev = img.device
    hs = np.array([b[2] for b in boxes])
    ws = np.array([b[3] for b in boxes])
    fx, xmin = _coefficients(ws, out_w, kind)
    fy, ymin = _coefficients(hs, out_h, kind)
    hmax, wmax = int(hs.max()), int(ws.max())
    chunk = max(1, _CHUNK_ELEMS // (hmax * wmax * 3))
    corner = torch.tensor([(t, lf) for t, lf, _, _ in boxes], device=dev)
    outs = []
    for c0 in range(0, len(boxes), chunk):
        part = slice(c0, c0 + chunk)
        n = len(hs[part])
        rows = torch.clamp(corner[part, :1] + torch.arange(hmax, device=dev), max=height - 1)
        cols = torch.clamp(corner[part, 1:] + torch.arange(wmax, device=dev), max=width - 1)
        x = img[rows[:, :, None], cols[:, None, :]]  # [n, hmax, wmax, 3]
        x = x.permute(0, 1, 3, 2).reshape(n, hmax * 3, wmax).double()
        t = _clip8(torch.bmm(x, _dense(fx[part], xmin[part], wmax, dev).transpose(1, 2)))
        acc = torch.bmm(_dense(fy[part], ymin[part], hmax, dev),
                        t.reshape(n, hmax, 3 * out_w).double())
        outs.append(_clip8(acc).reshape(n, out_h, 3, out_w).permute(0, 1, 3, 2))
    return torch.cat(outs).contiguous()


def resample(img: torch.Tensor, size: Tuple[int, int], kind: str = "bilinear") -> torch.Tensor:
    """``PIL.Image.resize(size, BILINEAR | BICUBIC)`` of an RGB image:
    uint8 [H, W, 3] -> uint8 [h, w, 3] for ``size = (w, h)``, on the
    image's device."""
    return resample_boxes(img, [(0, 0, img.shape[0], img.shape[1])], size, kind)[0]


def resize_short_side(img: torch.Tensor, size: int, kind: str = "bicubic") -> torch.Tensor:
    """Resize so the short side equals ``size`` (the long side to
    ``int(size * long / short)``); an image already there is returned."""
    h, w = img.shape[:2]
    short, long = (w, h) if w <= h else (h, w)
    if short == size:
        return img
    new_short, new_long = size, int(size * long / short)
    new_w, new_h = (new_short, new_long) if w <= h else (new_long, new_short)
    return resample(img, (new_w, new_h), kind)


def center_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    h, w = img.shape[:2]
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img[top : top + size, left : left + size]


def to_chw_array(img: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> float32 [..., 3, H, W] in [0, 1] (an IEEE
    division by 255 on every device, as numpy divides)."""
    return true_div(img.movedim(-1, -3).float(), 255.0)


def normalize(arr: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """(arr - mean) / std per channel of [..., 3, H, W] f32."""
    m = torch.tensor(mean, dtype=torch.float32, device=arr.device).reshape(3, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=arr.device).reshape(3, 1, 1)
    return (arr - m) / s


def preprocess_center(img: torch.Tensor, size: int = 224, resize_to: int = 256,
                      apply_normalize: bool = True) -> torch.Tensor:
    """The reference's center view: bicubic short side to ``resize_to``,
    center crop ``size``, [0, 1], CLIP normalization -> f32 [3, size,
    size] on the image's device."""
    arr = to_chw_array(center_crop(resize_short_side(img, resize_to, "bicubic"), size))
    return normalize(arr) if apply_normalize else arr


class RandomResizedCrop:
    """torchvision-semantics RandomResizedCrop, as the JAX class: uniform
    area in ``scale``, log-uniform aspect in ``ratio``, 10 attempts, then
    the closest central fit; a bilinear resize to ``size``."""

    def __init__(self, size: int = 224, scale: Tuple[float, float] = (0.5, 1.0),
                 ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)):
        self.size = size
        self.scale = scale
        self.ratio = ratio

    def sample_params(self, width: int, height: int, rng: np.random.Generator):
        """(top, left, h, w) crop box."""
        area = width * height
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(self.scale[0], self.scale[1])
            aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= width and 0 < h <= height:
                top = int(rng.integers(0, height - h + 1))
                left = int(rng.integers(0, width - w + 1))
                return top, left, h, w
        in_ratio = width / height
        if in_ratio < self.ratio[0]:
            w = width
            h = int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            h = height
            w = int(round(h * self.ratio[1]))
        else:
            w, h = width, height
        top = (height - h) // 2
        left = (width - w) // 2
        return top, left, h, w

    def __call__(self, img: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        height, width = img.shape[:2]
        box = self.sample_params(width, height, rng)
        return resample_boxes(img, [box], (self.size, self.size), "bilinear")[0]


class TTACropSampler:
    """The reference's TTA view set: ``n_views`` RandomResizedCrop views,
    each flipped left-right with probability ``flip_p``, from
    ``numpy.random.default_rng(SeedSequence([seed, image_index]))`` ->
    float32 [N, 3, size, size] on the image's device (CLIP-normalized with
    ``apply_normalize``)."""

    def __init__(self, n_views: int = 512, size: int = 224,
                 scale: Tuple[float, float] = (0.5, 1.0), flip_p: float = 0.5,
                 apply_normalize: bool = True, seed: int = 0):
        self.n_views = n_views
        self.crop = RandomResizedCrop(size=size, scale=scale)
        self.flip_p = flip_p
        self.apply_normalize = apply_normalize
        self.seed = seed

    def __call__(self, img: torch.Tensor, image_index: int = 0) -> torch.Tensor:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, image_index]))
        height, width = img.shape[:2]
        boxes, flips = [], []
        for _ in range(self.n_views):  # the JAX class's draws, in its order
            boxes.append(self.crop.sample_params(width, height, rng))
            flips.append(rng.random() < self.flip_p)
        size = self.crop.size
        views = resample_boxes(img, boxes, (size, size), "bilinear")
        flip = torch.tensor(flips, device=img.device)[:, None, None, None]
        views = torch.where(flip, views.flip(2), views)
        arr = to_chw_array(views)
        return normalize(arr) if self.apply_normalize else arr
