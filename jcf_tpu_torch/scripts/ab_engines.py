"""Times the ViT-B/32 serving engines end to end, for an A/B of two
checkouts on one NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_engines.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_engines.py --device cpu --batch 2 --iters 1 --layers 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

From seed-0 weights (``VIT_B_32``, ``--layers`` cuts the depth) and
seed-0 images of 256², b``--batch`` x 8 views, ``features_from_images``
against 403 seeded class vectors, one warm-up, then ``--iters`` timed
calls with fresh geometry each (host clock around work that ends in a
synchronize), for each engine:
- ``int8``: the serving engine, static "full" int8 calibrated on the
  images (``chip_smoke.py`` phase 8's);
- ``f32``: ``pipelines.build_engine`` from ``reference_preset()`` (the
  reference preset's f32 engine: the f32 float halves, phase 11's);
- ``bf16``: the same preset in bf16 (the parity engine, phase 11e's).
Each line gives ms/iter, img/s and the SHA-256 of the modes on one fixed
geometry (two checkouts computing the same bits share it).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, HERE)

from ab_gemm import digest, import_package  # noqa: E402

VIEWS, N_CLASSES = 8, 403


def run(root: str = ROOT, device="cuda", batch: int = 1024, iters: int = 5,
        layers: int = 12) -> dict:
    """Times each engine from ``root``'s package -> {engine: ms per
    iteration}."""
    import numpy as np
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = import_package(root)
    from jcf_tpu_torch.config import reference_preset
    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import VIT_B_32, init_clip_params
    from jcf_tpu_torch.pipelines.common import build_engine
    from jcf_tpu_torch.scripts.common import card_line

    print(card_line(device), flush=True)
    print(f"package: {package}", flush=True)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(VIT_B_32, vision_layers=layers)
    params = init_clip_params(0, cfg)
    rng = np.random.default_rng(0)
    images_np = rng.random((batch, 3, 256, 256)).astype(np.float32)
    text = rng.standard_normal((N_CLASSES, cfg.embed_dim)).astype(np.float32)
    text = torch.from_numpy(text / np.linalg.norm(text, axis=-1, keepdims=True)).to(device)
    images = torch.from_numpy(images_np).to(device, torch.bfloat16)

    def preset(dtype):
        pc = reference_preset()
        pc = dataclasses.replace(pc, tta=dataclasses.replace(pc.tta, n_views=VIEWS - 1),
                                 runtime=dataclasses.replace(pc.runtime, compute_dtype=dtype))
        return build_engine(params, cfg, pc, device=device)

    build = {"int8": lambda: TTAEngine(params, cfg, device=device, quant="int8",
                                       n_views=VIEWS - 1, calibration_images=images_np),
             "f32": lambda: preset("float32"), "bf16": lambda: preset("bfloat16")}
    res = {}
    for name, make in build.items():
        engine = make()
        geometry = engine.sample_geometry(torch.Generator(device=device).manual_seed(0), batch,
                                          images.shape[2:])
        sha = digest(engine.features_from_images(images, text, geometry=geometry))
        gen = torch.Generator(device=device).manual_seed(2)
        engine.features_from_images(images, text, generator=gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = engine.features_from_images(images, text, generator=gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) / iters * 1e3
        if not bool(out.isfinite().all()):
            raise AssertionError(f"non-finite modes from the {name} engine")
        res[name] = ms
        print(f"{name} engine, b{batch} x {VIEWS} views, {layers} layers: {ms:.2f} ms/iter, "
              f"{batch / ms * 1e3:.2f} img/s ({iters} iters), sha256 {sha}", flush=True)
        del engine, out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1024, help="images a call (x 8 views)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--layers", type=int, default=12, help="vision layers (12: ViT-B/32)")
    args = ap.parse_args(argv)
    run(args.root, args.device, args.batch, args.iters, args.layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
