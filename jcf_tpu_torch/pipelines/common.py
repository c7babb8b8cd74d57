"""Shared pipeline plumbing (``jcf_tpu/pipelines/common.py``): model
loading, the TTA engine of a configuration, the class templates, the
zero-shot text classifier with its disk cache, and the crop-cloud
stacking of the parity path."""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from jcf_tpu_torch.config import PipelineConfig
from jcf_tpu_torch.data import load_class_templates, synthesize_templates
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.models.clip import CLIPConfig
from jcf_tpu_torch.models.loader import load_clip
from jcf_tpu_torch.tta.classifier import build_classifier_weights

logger = logging.getLogger("jcf_tpu_torch")


def compute_dtype(cfg: PipelineConfig) -> torch.dtype:
    """bf16 for ``compute_dtype="bfloat16"`` (the perf preset), else f32
    (the default, the reference preset)."""
    return torch.bfloat16 if cfg.runtime.compute_dtype == "bfloat16" else torch.float32


def build_engine(params: dict, mcfg: CLIPConfig, cfg: PipelineConfig, first_batch=None, *,
                 device="cuda") -> TTAEngine:
    """The TTA engine of ``cfg``, as ``jcf_tpu/pipelines/ood.py:47-61``
    builds it: the compute dtype, ``tta.n_views`` random views (the center
    view is added) over ``tta.crop_scale``, ``runtime.quant`` and
    ``runtime.static_quant_mode``. With ``runtime.static_quant`` on the
    device-crop path (``tta.device_crops``) the int8 engine calibrates its
    static activation scales on ``first_batch``, the first decoded batch of
    source images, and raises without it; elsewhere the batch is not read
    and the int8 engine keeps dynamic scales."""
    calibrate = cfg.runtime.static_quant and cfg.tta.device_crops
    if calibrate and first_batch is None:
        raise ValueError("runtime.static_quant on the device-crop path calibrates on the first "
                         "decoded batch: pass it as first_batch")
    return TTAEngine(params, mcfg, device=device, n_views=cfg.tta.n_views,
                     crop_scale=cfg.tta.crop_scale, quant=cfg.runtime.quant,
                     dtype=compute_dtype(cfg), calibration_images=first_batch if calibrate else None,
                     static_quant_mode=cfg.runtime.static_quant_mode)


def load_model_for_pipeline(cfg: PipelineConfig, prompted: bool = False):
    """(params, model config) from ``cfg.runtime.clip_checkpoint``. With
    ``prompted`` a checkpoint without visual prompts gets 4 fresh ones
    (IVLP: ``vision_prompt_tokens = 4``, ``vpt`` drawn with numpy's
    ``default_rng(0)`` at std 0.02, as the JAX package draws them)."""
    params, mcfg = load_clip(cfg.runtime.clip_checkpoint)
    if prompted and mcfg.vision_prompt_tokens == 0:
        mcfg = dataclasses.replace(mcfg, vision_prompt_tokens=4)
        rng = np.random.default_rng(0)
        params["visual"]["vpt"] = torch.from_numpy(
            (0.02 * rng.standard_normal((4, mcfg.vision_width))).astype(np.float32))
    return params, mcfg


def ensure_templates(cfg: PipelineConfig) -> Dict[int, List[str]]:
    """Load the template directory, synthesizing it from the class list
    when it is missing or empty."""
    tdir = cfg.data.template_dir
    if not os.path.isdir(tdir) or not os.listdir(tdir):
        logger.info("template dir %s missing: synthesizing from %s", tdir, cfg.data.classes_file)
        synthesize_templates(cfg.data.classes_file, tdir, cfg.data.captions_file)
    return load_class_templates(tdir)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _classifier_cache_key(params: dict, mcfg: CLIPConfig, templates: Dict[int, List[str]],
                          cfg: PipelineConfig) -> str:
    """Content key of a built classifier: the model config, the compute
    dtype, the template texts, and the text tower's bytes (with dtype and
    shape) leaf by leaf in sorted path order."""
    h = hashlib.sha256()
    h.update(repr(mcfg).encode())
    h.update(str(cfg.runtime.compute_dtype).encode())
    for cid in sorted(templates.keys()):
        h.update(str(cid).encode())
        for s in templates[cid]:
            h.update(s.encode())
    for path, leaf in sorted(_leaves(params["text"]), key=lambda kv: kv[0]):
        t = leaf.detach().contiguous().cpu()
        h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def build_text_weights(params: dict, mcfg: CLIPConfig, templates: Dict[int, List[str]],
                       cfg: PipelineConfig, *, device="cuda") -> torch.Tensor:
    """Zero-shot classifier weights [C, D] in the compute dtype on
    ``device``, with a content-keyed disk cache under
    ``cfg.runtime.classifier_cache`` (None disables it). The cache file is
    an f32 ``.npy`` (numpy has no bfloat16), written atomically through a
    ``.tmp`` file and ``os.replace``; a hit returns it in the compute dtype."""
    dtype = compute_dtype(cfg)
    t0 = time.perf_counter()
    cache_dir = cfg.runtime.classifier_cache
    path = None
    if cache_dir:
        key = _classifier_cache_key(params, mcfg, templates, cfg)
        path = os.path.join(cache_dir, f"text_classifier_{key}.npy")
        if os.path.exists(path):
            w = torch.from_numpy(np.load(path)).to(device, dtype)
            logger.info("text classifier cache HIT: %s (%.2fs)", path, time.perf_counter() - t0)
            return w
    w = build_classifier_weights(params, mcfg, templates, device=device, dtype=dtype)
    logger.info("text classifier built in %.1fs (cache %s)", time.perf_counter() - t0,
                "miss" if cache_dir else "disabled")
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, w.float().cpu().numpy())
        os.replace(tmp, path)
        logger.info("text classifier cached: %s", path)
    return w


def stack_center_and_crops(center, crops) -> torch.Tensor:
    """[B, 1, 3, s, s] + [B, N, 3, s, s] -> [B, N + 1, 3, s, s] with the
    center view first (``ood.py:868-872``); numpy arrays or tensors in, a
    CPU tensor out."""
    return torch.from_numpy(np.concatenate([np.asarray(center), np.asarray(crops)], axis=1))
