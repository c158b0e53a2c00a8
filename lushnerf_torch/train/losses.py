"""Loss assembly.

Reference (run_lushnerf.py:652-661):
  loss = 0.5*MSE(rgb_blur, target) + 0.5*L1(rgb_blur, target)
       + 0.5*MSE(rgb0_blur, target) + 0.5*L1(rgb0_blur, target)
       (+ 1e-2 * consistency loss once i > noisenerf_start_iter)

plus the multi-view consistency term (:643-650): per-pixel confident mean
of the aligned renders, L1 against it, normalized by the confident count.
"""

from __future__ import annotations

import math

import torch

CONSIST_WEIGHT = 1e-2


def img2mse(x, y):
    return torch.mean((x - y) ** 2)


def img2l1(x, y):
    return torch.mean(torch.abs(x - y))


def mse2psnr(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)


def photometric_loss(rgb_blur, rgb0_blur, target):
    """The staged photometric loss on fine+coarse blur-composited colors.
    Returns (loss, mse of the fine color)."""
    mse = img2mse(rgb_blur, target)
    loss = (
        0.5 * mse
        + 0.5 * img2l1(rgb_blur, target)
        + 0.5 * img2mse(rgb0_blur, target)
        + 0.5 * img2l1(rgb0_blur, target)
    )
    return loss, mse


def masked_consistency_mean(rgb_align: torch.Tensor, confidence: torch.Tensor, threshold: float):
    """Confidence-masked per-pixel mean over views.

    rgb_align: [V, P, 3]; confidence: [V, P].  Matches
    compute_mean_with_confidence (helpers:665-688): pixels with no
    confident view get mean 0.
    """
    mask = (confidence >= threshold).to(rgb_align.dtype)  # [V, P]
    count = torch.sum(mask, dim=0)  # [P]
    total = torch.sum(rgb_align * mask[..., None], dim=0)  # [P, 3]
    mean = total / torch.clamp(count, min=1.0)[..., None]
    return mean, mask


def consistency_loss(rgb_align: torch.Tensor, confidence: torch.Tensor, threshold: float = 0.8):
    """CTE loss (run_lushnerf.py:646-650): L1 of each confident view's
    aligned render against the confident mean, normalized by the number of
    confident (view, pixel) entries."""
    mean, mask = masked_consistency_mean(rgb_align, confidence, threshold)
    num = torch.sum(torch.abs(rgb_align - mean[None]) * mask[..., None])
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return num / denom
