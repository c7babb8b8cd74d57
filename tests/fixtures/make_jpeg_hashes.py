"""Writes the card's references for the JPEG decoder, from a fixed seed:

    python tests/fixtures/make_jpeg_hashes.py

- ``tests/fixtures/jpeg/extra/``: four small JPEGs written with PIL from
  seeded content, each exercising a path of the decoder that the six
  fixtures of ``make_jpeg_fixtures.py`` do not: a progressive 4:2:0 image,
  a 4:2:0 image with restart markers every 3 MCUs and optimized Huffman
  tables, a 4:2:2 image, and a 4:4:4 image of odd size (13 x 7);
- ``tests/fixtures/jpeg/libjpeg_sha256.json``: for every JPEG under
  ``tests/fixtures/jpeg/`` (the six fixtures and the four above), the
  SHA-256 of PIL's decode, ``np.asarray(img.convert("RGB")).tobytes()``,
  and its shape, at full size and at each scale 1/2, 1/4, 1/8 that
  ``Image.draft`` reaches, with the Pillow and libjpeg-turbo versions
  that made them.

The card's host has neither PIL nor libjpeg: ``chip_smoke.py`` holds the
port's decode on the card to these hashes, and
``tests/test_torch_jpeg_exact.py`` checks on the CPU that they are
current.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(HERE, "jpeg")
EXTRA_DIR = os.path.join(JPEG_DIR, "extra")
HASHES = os.path.join(JPEG_DIR, "libjpeg_sha256.json")
SCALES = (1, 2, 4, 8)
# name -> (height, width, PIL save options)
EXTRA = {
    "x0_prog_420_97x131.jpg": (97, 131, {"quality": 85, "subsampling": 2, "progressive": True}),
    "x1_rst_420_75x203.jpg": (75, 203, {"quality": 90, "subsampling": 2, "optimize": True,
                                        "restart_marker_blocks": 3}),
    "x2_422_123x77.jpg": (123, 77, {"quality": 75, "subsampling": 1}),
    "x3_444_13x7.jpg": (13, 7, {"quality": 95, "subsampling": 0}),
}


def fixture_paths() -> list:
    """Every JPEG the hashes cover, relative to ``tests/fixtures/jpeg``."""
    top = sorted(f for f in os.listdir(JPEG_DIR) if f.endswith(".jpg"))
    extra = sorted(os.path.join("extra", f) for f in os.listdir(EXTRA_DIR) if f.endswith(".jpg"))
    return top + extra


def pil_decode(path: str, scale: int):
    """PIL's RGB decode of ``path`` at 1/``scale`` (uint8 [H, W, 3]), or
    None where ``Image.draft`` does not reach that scale."""
    from PIL import Image

    with Image.open(path) as img:
        if scale > 1:
            w, h = img.size
            if w // scale == 0 or h // scale == 0:
                return None
            img.draft("RGB", (w // scale, h // scale))
            if img.decoderconfig[0] != scale:
                return None
        return np.asarray(img.convert("RGB"))


def digest(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels, np.uint8).tobytes()).hexdigest()


def hashes() -> dict:
    import PIL
    from PIL import features

    images = {}
    for rel in fixture_paths():
        entry = {}
        for scale in SCALES:
            pixels = pil_decode(os.path.join(JPEG_DIR, rel), scale)
            if pixels is not None:
                entry[str(scale)] = {"shape": list(pixels.shape), "sha256": digest(pixels)}
        images[rel] = entry
    return {"pillow": PIL.__version__, "libjpeg_turbo": features.version("libjpeg_turbo"),
            "images": images}


def write_extra() -> None:
    from PIL import Image

    os.makedirs(EXTRA_DIR, exist_ok=True)
    rng = np.random.default_rng(12)
    for name, (h, w, options) in EXTRA.items():
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([128 + 100 * np.sin(xx / rng.uniform(3, 9) + yy / rng.uniform(3, 9) + c)
                        for c in range(3)], -1)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(EXTRA_DIR, name), **options)


def main() -> int:
    write_extra()
    with open(HASHES, "w") as f:
        json.dump(hashes(), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(EXTRA)} JPEGs to {EXTRA_DIR} and the hashes of "
          f"{len(fixture_paths())} to {HASHES}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
