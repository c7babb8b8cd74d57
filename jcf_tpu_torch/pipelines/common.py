"""Shared pipeline plumbing (``jcf_tpu/pipelines/common.py``): the class
templates and the zero-shot text classifier with its disk cache."""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from jcf_tpu_torch.config import PipelineConfig
from jcf_tpu_torch.data import load_class_templates, synthesize_templates
from jcf_tpu_torch.models.clip import CLIPConfig
from jcf_tpu_torch.tta.classifier import build_classifier_weights

logger = logging.getLogger("jcf_tpu_torch")


def compute_dtype(cfg: PipelineConfig) -> torch.dtype:
    """The text tower's dtype. Only the bf16 tower (the perf preset's) is
    ported; the f32 halves are not (ROADMAP.md)."""
    if cfg.runtime.compute_dtype != "bfloat16":
        raise NotImplementedError(
            f"compute_dtype {cfg.runtime.compute_dtype!r}: only the bf16 text tower is ported "
            "(use config.perf_preset())")
    return torch.bfloat16


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
    w = build_classifier_weights(params, mcfg, templates, device=device)
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
