"""The OOD split pipeline, ``jcf-ood`` (``jcf_tpu/pipelines/ood.py``).

Walks TestSetB, runs zero-shot MTA over each image's crop cloud and
splits the paths into base (pred <= 372) and new classes, writing
``TestSetB_1.txt`` and ``TestSetB_2.txt`` under the dataset root.

Two paths, as in the JAX package:

- the parity path (``tta.device_crops`` False, the default configuration,
  the reference preset: 512 + 1 crops, f32): images decode on ``device``
  (``data.decode``: PIL's pixels, byte for byte, on the card as on the
  CPU), the center view and the seeded crops come from the PIL-exact
  transforms of ``data.transforms``, and the engine encodes them with
  ``features_from_crops``; the split files equal the JAX package's byte
  for byte on the CPU;
- the throughput path (``tta.device_crops``, ``--perf``): square sources
  from ``data.decode.decode_batch`` (libjpeg's decode at its reduced
  scale, the triangle resize and the center crop, on the card), decoded
  one chunk ahead in a second thread while the card serves the current
  chunk, and ``features_from_images``
  with crop geometry sampled on the card. With ``runtime.static_quant``
  the int8 engine is built on the first decoded batch, which calibrates
  its static activation scales. The geometry comes from one
  ``torch.Generator`` on the device seeded 0 and drawn from batch after
  batch; ``jax.random``'s stream is not reproduced (the engine has drawn
  its geometry this way since it was ported), so the crops, and the
  predictions of images near a decision boundary, differ from the JAX
  package's on this path.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from jcf_tpu_torch.config import PipelineConfig
from jcf_tpu_torch.data import walk_test_dir
from jcf_tpu_torch.data.decode import decode_batch
from jcf_tpu_torch.infer.predict import OOD_BOUNDARY_PRED
from jcf_tpu_torch.pipelines.common import (
    build_engine,
    build_text_weights,
    ensure_templates,
    load_model_for_pipeline,
    serving_mesh,
    stack_center_and_crops,
    tta_loader,
)
from jcf_tpu_torch.utils import Timer, get_logger

logger = get_logger()


def run_ood_split(cfg: PipelineConfig, *, device="cuda", timer: Optional[Timer] = None) -> dict:
    """The split of ``cfg.data.test_dir`` -> {"n_base", "n_new",
    "base_path", "new_path"}. ``timer`` (a ``Timer``, made here when None)
    collects the phases "decode_wait" (the serving loop waiting for decoded
    images) and "tta_batch" (a batch on the device, up to its predictions
    on the host)."""
    device = torch.device(device)
    params, mcfg = load_model_for_pipeline(cfg)
    templates = ensure_templates(cfg)
    text_weights = build_text_weights(params, mcfg, templates, cfg, device=device)

    data = walk_test_dir(cfg.data.test_dir)
    logger.info("OOD split over %d images (%d views/image)", len(data), cfg.tta.n_views)
    serving_mesh(cfg)

    engine = None
    if not (cfg.runtime.static_quant and cfg.tta.device_crops):
        engine = build_engine(params, mcfg, cfg, device=device)

    base_path = os.path.join(cfg.data.root, "TestSetB_1.txt")
    new_path = os.path.join(cfg.data.root, "TestSetB_2.txt")
    os.makedirs(cfg.data.root, exist_ok=True)

    timer = Timer() if timer is None else timer
    n_base = n_new = 0
    with open(base_path, "w") as f1, open(new_path, "w") as f2:

        def write_preds(impaths, preds):
            nonlocal n_base, n_new
            for impath, pred in zip(impaths, preds):
                if pred <= OOD_BOUNDARY_PRED:
                    f1.write(impath + "\n")
                    n_base += 1
                else:
                    f2.write(impath + "\n")
                    n_new += 1

        def predict(modes):
            return torch.argmax(engine.logits(modes, text_weights), dim=-1).cpu().tolist()

        if cfg.tta.device_crops:
            gen = torch.Generator(device=device).manual_seed(0)
            bsz = cfg.tta.batch_images
            src = max(cfg.tta.resize_to * mcfg.image_resolution // 224, mcfg.image_resolution)
            chunks = [data[s : s + bsz] for s in range(0, len(data), bsz)]

            def decode(chunk):
                paths = [d.impath for d in chunk]
                return paths, decode_batch(paths, resize_to=src, out_size=src, device=device)

            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(decode, chunks[0]) if chunks else None
                for i in range(len(chunks)):
                    # the decode thread's images are ordered on the default
                    # stream (``data.jpeg`` waits its own stream into it)
                    with timer.phase("decode_wait"):
                        impaths, images = fut.result()
                    if i + 1 < len(chunks):
                        fut = pool.submit(decode, chunks[i + 1])
                    if engine is None:
                        # static activation scales, calibrated on the first batch
                        engine = build_engine(params, mcfg, cfg, images, device=device)
                    with timer.phase("tta_batch"):
                        modes = engine.features_from_images(images, text_weights, generator=gen)
                        preds = predict(modes)
                    write_preds(impaths, preds)
        else:
            batches = iter(tta_loader(cfg, data, mcfg, device=device))
            while True:
                with timer.phase("decode_wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                center, crops, _, impaths, _ = batch
                with timer.phase("tta_batch"):
                    modes = engine.features_from_crops(stack_center_and_crops(center, crops),
                                                       text_weights)
                    preds = predict(modes)
                write_preds(impaths, preds)

    logger.info("OOD split done: %d base / %d new: %s", n_base, n_new, timer.summary())
    return {"n_base": n_base, "n_new": n_new, "base_path": base_path, "new_path": new_path}
