"""Hashes the f32 paths' outputs on one NVIDIA GPU, for a bit-for-bit A/B
of two checkouts.

    python3 jcf_tpu_torch/scripts/ab_f32_paths.py [ROOT]   # the card

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` runs; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card: two checkouts that compute the same bits print the same
hashes. The inputs come from this checkout's ``chip_smoke.py`` helpers
(the fixture JPEGs, the synthetic class list, ``jcf-predict``'s
workspace), so both runs read the same files.

On the seed-0 ViT-B/32 (random weights), f32 everywhere, TF32 off:
- the f32 engine (``pipelines.build_engine`` of ``reference_preset()`` at
  8 views): ``features_from_images`` of 1024 seeded images (256², the
  views from generator seed 2), the modes;
- its ``features_from_crops`` at 8 images x 513 seeded crops, the modes;
- the f32 classifier build (``build_text_weights`` under
  ``PipelineConfig()``, no cache) of 403 synthetic classes x 8 templates;
- ``jcf-ood``'s default configuration (``cli.ood.main``) on 16 fixture
  images: the two split files;
- ``jcf-predict``'s f32 default (``cli.predict.main``) on
  ``chip_smoke.predict_workspace``: the three result files.
Each line prints the SHA-256 of the output's bytes (in the files the
temporary directory's name replaced by a fixed one) and the seconds the
step took (host clock, set-up included).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import os
import pickle
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sha(*blobs) -> str:
    """SHA-256 (first 16 hex digits) of tensors' or byte strings' bytes (the
    files with their temporary directory's name replaced by a fixed one,
    since they list image paths)."""
    h = hashlib.sha256()
    for b in blobs:
        h.update(b if isinstance(b, bytes)
                 else b.detach().contiguous().cpu().reshape(-1).numpy().tobytes())
    return h.hexdigest()[:16]


def run(root: str = ROOT) -> dict:
    """Every output of the list above from ``root``'s package -> {name:
    hash}."""
    ab = _load(os.path.join(HERE, "ab_gemm.py"), "_ab_gemm")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = ab.import_package(root)
    smoke = _load(os.path.join(ROOT, "chip_smoke.py"), "_chip_smoke")
    from jcf_tpu_torch.cli import ood as cli_ood
    from jcf_tpu_torch.cli import predict as cli_predict
    from jcf_tpu_torch.config import DataConfig, PipelineConfig, RuntimeConfig, reference_preset
    from jcf_tpu_torch.models.clip import CLIP_MEAN, CLIP_STD, VIT_B_32, init_clip_params
    from jcf_tpu_torch.models.loader import state_dict_from_params
    from jcf_tpu_torch.ops import view_kernel as vk
    from jcf_tpu_torch.pipelines.common import build_engine, build_text_weights, ensure_templates
    from jcf_tpu_torch.scripts.common import card_line

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(dev), flush=True)
    print(f"package: {package}", flush=True)
    cfg = VIT_B_32
    params = init_clip_params(0, cfg)
    out = {}

    def line(name, t0, *blobs):
        out[name] = sha(*blobs)
        print(f"{name}: sha256 {out[name]} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    engine = build_engine(params, cfg, dataclasses.replace(
        reference_preset(), tta=dataclasses.replace(reference_preset().tta, n_views=7)), device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((1024, 3, 256, 256)).astype(np.float32)).to(dev)
    text = torch.nn.functional.normalize(torch.randn(
        403, cfg.embed_dim, device=dev, generator=torch.Generator(device=dev).manual_seed(1)), dim=-1)
    modes = engine.features_from_images(images, text,
                                        generator=torch.Generator(device=dev).manual_seed(2))
    line("f32 engine features_from_images, b1024 x 8 views", t0, modes)
    t0 = time.perf_counter()
    src = images[:8]
    cy, cx, inv = vk.sample_view_centers(torch.Generator(device=dev).manual_seed(3), 8, 513,
                                         tuple(src.shape[2:]), cfg.image_resolution)
    mean = torch.tensor(CLIP_MEAN, device=dev).reshape(1, 1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=dev).reshape(1, 1, 3, 1, 1)
    crops = (vk.fused_views_nchw_plain(src, cy, cx, inv, cfg.image_resolution) - mean) / std
    line("f32 engine features_from_crops, 8 x 513 crops", t0,
         engine.features_from_crops(crops, text))
    del engine, images, crops
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        smoke.synthetic_classes(os.path.join(tmp, "classes.txt"))
        pc = PipelineConfig(DataConfig(os.path.join(tmp, "classes.txt"), os.path.join(tmp, "tpl"),
                                       ""), RuntimeConfig("float32", None))
        line("f32 classifier build, 403 x 8 prompts", t0,
             build_text_weights(params, cfg, ensure_templates(pc), pc, device=dev))

        t0 = time.perf_counter()
        ds = smoke.ood_dataset(os.path.join(tmp, "Dataset"), smoke.OOD_IMAGES)
        ckpt = os.path.join(tmp, "ViT-B-32.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump(state_dict_from_params(params, cfg), f)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            res = cli_ood.main(["--root_path", ds, "--clip_checkpoint", ckpt, "--device", "cuda"])
            files = [open(res[k], "rb").read() for k in ("base_path", "new_path")]
        finally:
            os.chdir(cwd)
        line(f"jcf-ood default, {smoke.OOD_IMAGES} images (the split files)", t0,
             *(f.replace(tmp.encode(), b"<tmp>") for f in files))

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        smoke.predict_workspace(tmp, params, cfg)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            cli_predict.main(["--root_path", "Dataset", "--clip_checkpoint", "ViT-B-32.pkl",
                              "--results_dir", "final", "--device", "cuda"])
            files = [open(os.path.join("final", n), "rb").read()
                     for n in ("top5_results6.txt", "top5_results_ood.txt", "result.txt")]
        finally:
            os.chdir(cwd)
        line("jcf-predict f32 default (the three result files)", t0,
             *(f.replace(tmp.encode(), b"<tmp>") for f in files))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package runs")
    args = ap.parse_args(argv)
    run(args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
