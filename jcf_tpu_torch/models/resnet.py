"""The torchvision-style ResNet-50 of ``jcf_tpu/models/resnet.py`` that
``jcf-predict`` runs: the frozen MoCo-v3 feature extractor (the
reference's ``load_moco``: ``base_encoder.`` stripped from the
checkpoint, ``fc`` replaced by identity -> 2048-d features).

BatchNorm runs in inference mode (running statistics), its scale and
shift computed in f32 and cast to the compute dtype, as the JAX package
computes them. The convolutions are ``torch.nn.functional.conv2d`` in the
compute dtype: the JAX package runs them as XLA convolutions
(``jax.lax.conv_general_dilated`` at ``Precision.HIGHEST``) outside any
Pallas kernel. In f32 on the card cuDNN would run them in TF32 while
``torch.backends.cudnn.allow_tf32`` is set (PyTorch's default), so the f32
tower raises there unless it and ``torch.backends.cuda.matmul.allow_tf32``
are False.

Parameters are the JAX tree's: ``{"conv1", "bn1", "layers": [stage:
[block: {"conv1".."conv3", "bn1".."bn3", "downsample"?}]]}`` with OIHW
conv weights and BN dicts of ``weight``, ``bias``, ``running_mean``,
``running_var``. ``init_resnet50_params`` draws the same numpy values in
the same order as the JAX function, so a seed gives the same weights on a
host without JAX.

Not ported (no path of the port runs them): CLIP's ``ModifiedResNet``
(``clip_resnet.py``) and the MoCo ViT (``vit_moco.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from jcf_tpu_torch.ops.layers import require_f32_products

_BN_EPS = 1e-5
RESNET50_LAYERS = (3, 4, 6, 3)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NCHW x OIHW convolution in x's dtype."""
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def batch_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Inference-mode BN over NCHW with running statistics: the scale and
    shift in f32, cast to x's dtype, then ``x * scale + shift``."""
    rstd = torch.sqrt(p["running_var"] + _BN_EPS)
    scale = (p["weight"] / rstd).to(x.dtype)
    shift = (p["bias"] - p["running_mean"] * p["weight"] / rstd).to(x.dtype)
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _bottleneck(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    identity = x
    out = torch.relu(batch_norm(conv2d(x, p["conv1"]), p["bn1"]))
    out = torch.relu(batch_norm(conv2d(out, p["conv2"], stride=stride, padding=1), p["bn2"]))
    out = batch_norm(conv2d(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        identity = batch_norm(conv2d(x, p["downsample"]["conv"], stride=stride),
                              p["downsample"]["bn"])
    return torch.relu(out + identity)


def resnet50_features(params: dict, images: torch.Tensor, *,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, 3, H, W] -> [B, 2048] pooled features in ``dtype`` (fc ==
    identity), where ``images`` and ``params`` lie."""
    if dtype == torch.float32:
        require_f32_products(images.device, "the f32 ResNet-50")
    x = images.to(dtype)
    x = torch.relu(batch_norm(conv2d(x, params["conv1"], stride=2, padding=3), params["bn1"]))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage_idx, stage in enumerate(params["layers"]):
        for block_idx, block in enumerate(stage):
            x = _bottleneck(x, block, 2 if (stage_idx > 0 and block_idx == 0) else 1)
    return x.mean(dim=(2, 3))  # global average pool


def moco_params_from_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """A MoCo-v3 checkpoint (flat, or ``base_encoder.``-prefixed with its
    momentum encoder and heads beside it) -> the ``resnet50_features`` tree;
    the ``fc`` head is dropped (identity)."""
    flat = {}
    for k, v in sd.items():
        if k.startswith("base_encoder.") and not k.startswith("base_encoder.fc"):
            flat[k[len("base_encoder."):]] = np.asarray(v)
        elif not k.startswith("base_encoder"):
            flat[k] = np.asarray(v)
    return resnet50_params_from_flat(flat)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.array(a, np.float32)))


def _bn_tree(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    return {k: _t(flat[f"{prefix}.{k}"]) for k in ("weight", "bias", "running_mean", "running_var")}


def resnet50_params_from_flat(flat: Dict[str, np.ndarray]) -> dict:
    """torchvision names (``conv1.weight``, ``layer1.0.bn1.running_var``,
    ``layer1.0.downsample.0.weight``, ...) -> the tree, f32 CPU tensors."""
    params = {"conv1": _t(flat["conv1.weight"]), "bn1": _bn_tree(flat, "bn1"), "layers": []}
    for stage_idx, n_blocks in enumerate(RESNET50_LAYERS, start=1):
        stage: List[dict] = []
        for b in range(n_blocks):
            pre = f"layer{stage_idx}.{b}"
            block = {}
            for i in (1, 2, 3):
                block[f"conv{i}"] = _t(flat[f"{pre}.conv{i}.weight"])
                block[f"bn{i}"] = _bn_tree(flat, f"{pre}.bn{i}")
            if f"{pre}.downsample.0.weight" in flat:
                block["downsample"] = {"conv": _t(flat[f"{pre}.downsample.0.weight"]),
                                       "bn": _bn_tree(flat, f"{pre}.downsample.1")}
            stage.append(block)
        params["layers"].append(stage)
    return params


def init_resnet50_params(seed: int = 0) -> dict:
    """Random-init RN50 tree, value-identical to
    ``jcf_tpu.models.resnet.init_resnet50_params(seed)``: He-normal convs
    from ``numpy.random.default_rng(seed)`` in the same order, identity
    BatchNorms."""
    rng = np.random.default_rng(seed)

    def conv(o, i, k):
        return torch.from_numpy(
            (rng.standard_normal((o, i, k, k)) * np.sqrt(2.0 / (i * k * k))).astype(np.float32))

    def bn(c):
        return {"weight": torch.ones(c), "bias": torch.zeros(c), "running_mean": torch.zeros(c),
                "running_var": torch.ones(c)}

    params = {"conv1": conv(64, 3, 7), "bn1": bn(64), "layers": []}
    inplanes = 64
    for stage_idx, n_blocks in enumerate(RESNET50_LAYERS):
        planes = 64 * (2**stage_idx)
        stage = []
        for b in range(n_blocks):
            block = {"conv1": conv(planes, inplanes, 1), "bn1": bn(planes),
                     "conv2": conv(planes, planes, 3), "bn2": bn(planes),
                     "conv3": conv(planes * 4, planes, 1), "bn3": bn(planes * 4)}
            if b == 0:
                block["downsample"] = {"conv": conv(planes * 4, inplanes, 1), "bn": bn(planes * 4)}
            stage.append(block)
            inplanes = planes * 4
        params["layers"].append(stage)
    return params
