"""MTA: Gaussian-kernel robust mode seeking (``jcf_tpu/tta/mta.py``).

Plain f32 PyTorch over a batch of crop-feature clouds. The reference's
inner do-while loops (at least one step, then stop when the update norm
drops below ``th`` or after ``max_iter`` steps) run per image: each image
carries an active mask and keeps its value once it has stopped, as the
vmapped ``lax.while_loop`` does. The loops always run ``max_iter`` steps,
so nothing waits on the device to decide whether to continue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LAMBDA_Y = 0.2
LAMBDA_Q = 4.0
MAX_ITER = 5
TEMPERATURE = 1.0
KNN_FRAC = 0.3
LOGIT_SCALE = 100.0
CONVERGENCE_TH = 1e-6


class MTAParams(NamedTuple):
    lambda_y: float = LAMBDA_Y
    lambda_q: float = LAMBDA_Q
    max_iter: int = MAX_ITER
    temperature: float = TEMPERATURE
    knn_frac: float = KNN_FRAC
    th: float = CONVERGENCE_TH


def _pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """Euclidean cdist over [B, N, D] via the expanded quadratic, clamped
    at zero before the sqrt."""
    sq = (x * x).sum(dim=-1, keepdim=True)
    d2 = sq - 2.0 * torch.matmul(x, x.transpose(-1, -2)) + sq.transpose(-1, -2)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _bounded_fixed_point(update, init, th, max_iter):
    """Per-image do-while: step at least once, then while ||delta|| >= th
    and fewer than max_iter steps. init [B, ...]."""
    val = init
    delta = torch.full(init.shape[:1], float("inf"), device=init.device)
    for i in range(max_iter):
        active = (delta >= th) if i else torch.ones_like(delta, dtype=torch.bool)
        new_val = update(val)
        new_delta = (new_val - val).flatten(1).norm(dim=1)
        mask = active.reshape((-1,) + (1,) * (val.dim() - 1))
        val = torch.where(mask, new_val, val)
        delta = torch.where(active, new_delta, delta)
    return val


def solve_mta_batch(crop_features: torch.Tensor, text_features: torch.Tensor,
                    params: MTAParams = MTAParams()) -> torch.Tensor:
    """Robust modes of a batch of crop clouds.

    crop_features: [B, N, D] L2-normalized crop features (view 0 = center)
    text_features: [C, D] L2-normalized class weights
    Returns the L2-normalized modes [B, D].
    """
    feats = crop_features.float()
    n = feats.shape[1]
    logits = torch.matmul(feats, text_features.float().T) * LOGIT_SCALE

    dist = _pairwise_dist(feats)
    k = max(int(params.knn_frac * (n - 1)), 1)
    sorted_vals = torch.sort(dist, dim=-1).values
    mean_sq = (sorted_vals[..., 1 : k + 1] ** 2).mean(dim=-1)
    bandwidth = torch.sqrt(0.5 * mean_sq)  # [B, N]

    probs = torch.softmax(logits / params.temperature, dim=-1)
    affinity = torch.matmul(probs, probs.transpose(-1, -2))  # [B, N, N]

    def density(mode):  # mode [B, D] -> [B, N]
        d = (feats - mode[:, None, :]).norm(dim=-1)
        return torch.exp(-(d**2) / (2.0 * bandwidth**2))

    y = torch.full(feats.shape[:2], 1.0 / n, device=feats.device)
    mode = feats[:, 0]
    for _ in range(params.max_iter):
        dens = density(mode)

        def update_y(y):
            weighted = affinity * y[:, None, :]
            return torch.softmax(
                (dens + params.lambda_q * weighted.sum(dim=-1)) / params.lambda_y, dim=-1
            )

        y = _bounded_fixed_point(update_y, y, params.th, params.max_iter)

        def update_mode(mode):
            wd = density(mode) * y
            new_mode = (wd[..., None] * feats).sum(dim=1) / wd.sum(dim=1, keepdim=True)
            return new_mode / new_mode.norm(dim=-1, keepdim=True)

        mode = _bounded_fixed_point(update_mode, mode, params.th, params.max_iter)
    return mode


def solve_mta(image_features: torch.Tensor, text_features: torch.Tensor,
              params: MTAParams = MTAParams()) -> torch.Tensor:
    """Robust mode [D] of one crop cloud [N, D]."""
    return solve_mta_batch(image_features[None], text_features, params)[0]
