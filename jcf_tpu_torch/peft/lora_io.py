"""LoRA checkpoint files (``jcf_tpu/peft/lora_io.py``), in the reference's
format: a pickle of ``{"weights": {"layer_{i}": {"{q,k,v}_proj"|"proj":
{"w_lora_A": [r, W], "w_lora_B": [W, r]}}}, "metadata": {r, alpha, encoder,
params, position}}`` with f32 numpy arrays. Layers are numbered in
``apply_lora`` order: the selected text-tower blocks first, then the
selected vision-tower blocks. A file either package writes loads in the
other.

``load_lora`` validates every metadata field strictly; ``load_lora_swa``
averages every checkpoint of a folder (stochastic weight averaging).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from jcf_tpu_torch.peft.lora import LoraSpec, init_lora_params

_PROJ_KEYS = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "proj"}
_PROJ_INDEX = {"q": 0, "k": 1, "v": 2}


def _selected(spec: LoraSpec, n_text: int, n_vision: int) -> List[Tuple[str, int]]:
    return ([("text", i) for i in spec.text_indices(n_text)]
            + [("vision", i) for i in spec.vision_indices(n_vision)])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def lora_to_reference_weights(lora: dict, spec: LoraSpec, n_text: int, n_vision: int) -> dict:
    """The stacked LoRA tree -> the reference's per-layer weights dict."""
    weights: Dict[str, dict] = {}
    for file_idx, (tower, layer) in enumerate(_selected(spec, n_text, n_vision)):
        t = lora[tower]
        layer_weights = {}
        for p in spec.params:
            if p == "o":
                layer_weights["proj"] = {"w_lora_A": _np(t["a_out"][layer]),
                                         "w_lora_B": _np(t["b_out"][layer])}
            else:
                pi = _PROJ_INDEX[p]
                layer_weights[_PROJ_KEYS[p]] = {"w_lora_A": _np(t["a_qkv"][layer, pi]),
                                                "w_lora_B": _np(t["b_qkv"][layer, pi])}
        weights[f"layer_{file_idx}"] = layer_weights
    return weights


def save_lora(lora: dict, spec: LoraSpec, path: str, n_text: int = 12, n_vision: int = 12) -> None:
    payload = {
        "weights": lora_to_reference_weights(lora, spec, n_text, n_vision),
        "metadata": {"r": spec.r, "alpha": spec.alpha, "encoder": spec.encoder,
                     "params": list(spec.params), "position": spec.position},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _validate_metadata(metadata: dict, spec: LoraSpec) -> None:
    checks = [("r", spec.r), ("alpha", spec.alpha), ("encoder", spec.encoder),
              ("params", list(spec.params)), ("position", spec.position)]
    for key, expected in checks:
        if metadata[key] != expected:
            raise ValueError(f"{key} mismatch: expected {expected}, found {metadata[key]}")


def _weights_into_lora(weights: dict, spec: LoraSpec, lora: dict, n_text: int,
                       n_vision: int) -> dict:
    out = {k: {kk: _np(vv) for kk, vv in v.items()} for k, v in lora.items()}
    for file_idx, (tower, layer) in enumerate(_selected(spec, n_text, n_vision)):
        layer_weights = weights[f"layer_{file_idx}"]
        for p in spec.params:
            key = _PROJ_KEYS[p]
            if key not in layer_weights:
                continue
            a = np.asarray(layer_weights[key]["w_lora_A"], np.float32)
            b = np.asarray(layer_weights[key]["w_lora_B"], np.float32)
            if p == "o":
                out[tower]["a_out"][layer] = a
                out[tower]["b_out"][layer] = b
            else:
                pi = _PROJ_INDEX[p]
                out[tower]["a_qkv"][layer, pi] = a
                out[tower]["b_qkv"][layer, pi] = b
    return {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in out.items()}


def _empty_lora(spec: LoraSpec, n_text: int, text_width: int, n_vision: int,
                vision_width: int) -> dict:
    lora = init_lora_params(0, spec, n_text, text_width, n_vision, vision_width)
    return {k: {kk: torch.zeros_like(vv) for kk, vv in v.items()} for k, v in lora.items()}


def load_lora(path: str, spec: LoraSpec, *, n_text: int = 12, text_width: int = 512,
              n_vision: int = 12, vision_width: int = 768, into: Optional[dict] = None) -> dict:
    """Load factors from a reference-format pkl into a stacked LoRA tree of
    CPU f32 tensors (zeros, or ``into``'s values, where the file has none)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"File {path} does not exist.")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    _validate_metadata(payload["metadata"], spec)
    base = into if into is not None else _empty_lora(spec, n_text, text_width, n_vision,
                                                     vision_width)
    return _weights_into_lora(payload["weights"], spec, base, n_text, n_vision)


def load_lora_swa(folder: str, spec: LoraSpec, *, n_text: int = 12, text_width: int = 512,
                  n_vision: int = 12, vision_width: int = 768) -> dict:
    """Average every LoRA pkl in ``folder`` (SWA, in float64), then load
    the average."""
    if not os.path.exists(folder):
        raise FileNotFoundError(f"Folder {folder} does not exist.")
    accumulated: Optional[dict] = None
    count = 0
    for filename in sorted(os.listdir(folder)):
        path = os.path.join(folder, filename)
        if os.path.isdir(path):
            continue
        with open(path, "rb") as f:
            payload = pickle.load(f)
        _validate_metadata(payload["metadata"], spec)
        w = payload["weights"]
        if accumulated is None:
            accumulated = {lk: {pk: {ak: np.asarray(av, np.float64).copy() for ak, av in pv.items()}
                                for pk, pv in lv.items()} for lk, lv in w.items()}
        else:
            for lk, lv in w.items():
                for pk, pv in lv.items():
                    for ak, av in pv.items():
                        accumulated[lk][pk][ak] += np.asarray(av, np.float64)
        count += 1
    if not count:
        raise ValueError(f"No LoRA checkpoints found in {folder}")
    averaged = {lk: {pk: {ak: (av / count).astype(np.float32) for ak, av in pv.items()}
                     for pk, pv in lv.items()} for lk, lv in accumulated.items()}
    base = _empty_lora(spec, n_text, text_width, n_vision, vision_width)
    return _weights_into_lora(averaged, spec, base, n_text, n_vision)
