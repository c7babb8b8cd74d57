"""Classification heads over frozen features (``jcf_tpu/heads``).

- ``channel_lp``: LP++-style channel reweighting, a per-channel scale
  (ones) and bias (zeros), then a 512 -> C linear whose weight starts as
  the zero-shot text classifier;
- ``moco_adapter``: a 2048 -> C linear over the frozen MoCo-v3 ResNet-50
  features, its weight starting as the per-class sums of the training
  features.

Parameters are dicts of f32 tensors with the JAX trees' keys, so the
pickles ``jcf_tpu``'s ``save_pytree`` writes load through
``utils.load_pytree``. The linears are ``ops.layers.linear`` on f32
features (plain f32 products): the JAX package leaves them to XLA outside
any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from jcf_tpu_torch.ops.layers import linear


def init_channel_lp(num_classes: int = 403, feat_dim: int = 512,
                    text_weights: Optional[torch.Tensor] = None) -> dict:
    """``text_weights``: the zero-shot classifier [C, D] the fc starts
    from (copied, never aliased)."""
    fc_w = (text_weights.detach().float().clone() if text_weights is not None
            else torch.zeros(num_classes, feat_dim))
    return {"scale1": torch.ones(feat_dim), "bias1": torch.zeros(feat_dim),
            "fc": {"w": fc_w, "b": torch.zeros(num_classes)}}


def channel_lp(params: dict, features: torch.Tensor) -> torch.Tensor:
    x = params["scale1"][None, :] * features + params["bias1"][None, :]
    return linear(x, params["fc"]["w"], params["fc"]["b"])


def init_moco_adapter(num_classes: int = 403, feat_dim: int = 2048,
                      class_feature_sums: Optional[torch.Tensor] = None) -> dict:
    """``class_feature_sums``: per-class sums [C, D] of the training MoCo
    features (copied, never aliased)."""
    fc_w = (class_feature_sums.detach().float().clone() if class_feature_sums is not None
            else torch.zeros(num_classes, feat_dim))
    return {"fc": {"w": fc_w, "b": torch.zeros(num_classes)}}


def moco_adapter(params: dict, features: torch.Tensor) -> torch.Tensor:
    return linear(features, params["fc"]["w"], params["fc"]["b"])


def moco_adapter_init_from_features(features: torch.Tensor, labels: torch.Tensor,
                                    num_classes: int = 403) -> torch.Tensor:
    """Per-class feature sums [C, D]: one-hot(labels)^T @ features."""
    onehot = F.one_hot(labels.long(), num_classes).to(features.dtype)  # [N, C]
    return onehot.T @ features
