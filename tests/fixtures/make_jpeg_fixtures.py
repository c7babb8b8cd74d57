"""Writes the JPEG fixtures of the decoder tests and their reference
decodes, from a fixed seed:

    JAX_PLATFORMS=cpu python tests/fixtures/make_jpeg_fixtures.py

Six JPEGs under ``tests/fixtures/jpeg/`` (smooth seeded content: color
waves and soft discs), with short sides below and above 512
(the size from which ``jcf_tpu.native`` decodes at a reduced DCT scale),
4:2:0 and 4:4:4 chroma and one grayscale image, and their reference
decodes at 256 x 256:

- ``tests/fixtures/jpeg/pil_256/<name>.png``: PIL's decode, then
  ``jcf_tpu_torch.data.decode``'s short-side triangle resize and center
  crop on the CPU (PNG compresses these smooth images about 4x better
  than ``np.savez_compressed``);
- ``tests/fixtures/jpeg/native_minus_pil.npz``: ``names`` (the file
  names) and ``delta``, ``jcf_tpu.native.decode_batch(paths, 256, 256)``
  (libjpeg with its reduced-scale decode) as uint8 [N, 256, 256, 3] minus
  the PIL references, int8.

The card has neither PIL nor libjpeg; ``chip_smoke.py`` holds its nvJPEG
decode against both arrays.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jpeg")
# (name, height, width, mode, subsampling (PIL: 0 = 4:4:4, 2 = 4:2:0), quality)
FIXTURES = [
    ("f0_420_240x320.jpg", 240, 320, "RGB", 2, 90),
    ("f1_444_333x250.jpg", 333, 250, "RGB", 0, 90),
    ("f2_gray_300x280.jpg", 300, 280, "L", None, 90),
    ("f4_420_540x720.jpg", 540, 720, "RGB", 2, 80),
    ("f5_444_600x560.jpg", 600, 560, "RGB", 0, 80),
    ("f6_420_1040x1100.jpg", 1040, 1100, "RGB", 2, 70),
]


def _content(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth uint8 RGB [h, w, 3]: a random wave per channel and a few
    soft discs."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        a, b, p = rng.uniform(-0.4, 0.4, 3)
        img[..., c] = 128 + 90 * np.sin(a * xx / 40 + b * yy / 40 + 6 * p)
    for _ in range(5):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.25) * min(h, w)
        color = rng.uniform(0, 255, 3)
        mask = 1 / (1 + np.exp(np.minimum((((yy - cy) ** 2 + (xx - cx) ** 2) ** 0.5 - r) / 4, 50)))
        img = img * (1 - mask[..., None]) + color * mask[..., None]
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def main() -> int:
    from PIL import Image

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from jcf_tpu.native import decode_batch as native_decode_batch
    from jcf_tpu_torch.data.decode import decode_batch

    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(0)
    paths = []
    for name, h, w, mode, sub, quality in FIXTURES:
        img = Image.fromarray(_content(rng, h, w))
        kw = {"quality": quality}
        if mode == "L":
            img = img.convert("L")
        else:
            kw["subsampling"] = sub
        path = os.path.join(OUT, name)
        img.save(path, **kw)
        paths.append(path)
    pil = decode_batch(paths, 256, 256, device="cpu", uint8=True).numpy()
    native = np.round(native_decode_batch(paths, 256, 256) * 255).astype(np.uint8)
    os.makedirs(os.path.join(OUT, "pil_256"), exist_ok=True)
    for (name, *_), ref in zip(FIXTURES, pil):
        Image.fromarray(ref).save(os.path.join(OUT, "pil_256", name[:-4] + ".png"), optimize=True)
    delta = native.transpose(0, 2, 3, 1).astype(np.int16) - pil
    np.savez_compressed(os.path.join(OUT, "native_minus_pil.npz"), delta=delta.astype(np.int8),
                        names=np.array([f[0] for f in FIXTURES]))
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {len(paths)} JPEGs and their references to {OUT}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
