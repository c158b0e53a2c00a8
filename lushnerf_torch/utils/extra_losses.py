"""Auxiliary loss and analysis utilities from the reference helper module.

A port of lushnerf_tpu/utils/extra_losses.py, the counterparts of
utils/run_lushnerf_helpers.py's extras: the MS-SSIM + L1 loss (:26-107),
white balance (:110-132), the correlation coefficient (:14-22) and kernel
density estimation (:691-713).  The shipped training recipe uses none of
them (the reference keeps them dormant too); they are part of the
framework's surface for experiments.  Each runs on its inputs' device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from lushnerf_torch.models.lushnerf import resolve_device


def compute_correlation_coefficient(x: torch.Tensor, y: torch.Tensor,
                                    eps: float = 1e-6) -> torch.Tensor:
    """Per-column Pearson correlation (helpers:14-22). x, y: [N, D]."""
    xm = x - x.mean(dim=0, keepdim=True)
    ym = y - y.mean(dim=0, keepdim=True)
    num = torch.sum(xm * ym, dim=0)
    den = torch.sqrt(torch.sum(xm**2, dim=0) * torch.sum(ym**2, dim=0))
    return num / (den + eps)


def kde(x: torch.Tensor, std: float = 0.1) -> torch.Tensor:
    """Gaussian kernel density over a point set x [N, D] (helpers:691-713):
    one pairwise distance matrix on the device."""
    d2 = torch.sum((x[:, None, :] - x[None, :, :]) ** 2, dim=-1)
    return torch.sum(torch.exp(-d2 / (2 * std**2)), dim=-1) / x.shape[0]


def white_balance_init(map_type: str, num_images: int,
                       device: str | torch.device = "cuda") -> Dict[str, torch.Tensor]:
    """WhiteBalance parameters at their init, ones, on `device`
    (helpers:110-120): 'white_balance' a gain per image and channel (`wb`
    [num_images, 3]), 'white_balance_consistent' one per channel (`wb`
    [3]), 'none' none."""
    device = resolve_device(device)
    if map_type == "none":
        return {}
    if map_type == "white_balance":
        return {"wb": torch.ones((num_images, 3), device=device, requires_grad=True)}
    if map_type == "white_balance_consistent":
        return {"wb": torch.ones((3,), device=device, requires_grad=True)}
    raise ValueError(f"map_type {map_type!r} not recognized")


def white_balance_apply(params: Dict[str, torch.Tensor], map_type: str, x: torch.Tensor,
                        img_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    if map_type == "none":
        return x
    if map_type == "white_balance":
        return x * params["wb"][img_idx]
    if map_type == "white_balance_consistent":
        return x * params["wb"]
    raise ValueError(f"map_type {map_type!r} not recognized")


def _gauss_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(coords**2) / (2 * sigma**2))
    return g / torch.sum(g)


def ms_ssim_l1_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    sigmas=(0.5, 1.0, 2.0, 4.0, 8.0),
    data_range: float = 1.0,
    K=(0.01, 0.03),
    alpha: float = 0.025,
    compensation: float = 200.0,
) -> torch.Tensor:
    """MS-SSIM + Gaussian-weighted L1 mix (MS_SSIM_L1_LOSS, helpers:26-107).

    x, y: [B, 3, H, W] in [0, data_range].  The Gaussian bank is one grouped
    convolution (groups=3) over 3 x len(sigmas) filters in the reference's
    sigma-major order: output channel j reads input channel
    j // len(sigmas) with sigmas[j // 3], the reference's pairing, kept.
    The L1 term is filtered by the last three (the largest sigma).
    """
    C1 = (K[0] * data_range) ** 2
    C2 = (K[1] * data_range) ** 2
    pad = int(2 * sigmas[-1])
    size = int(4 * sigmas[-1] + 1)

    kernels = []
    for s in sigmas:
        g1 = _gauss_kernel1d(size, s, x.device)
        kernels.append(torch.outer(g1, g1))
    g_masks = torch.stack([k for k in kernels for _ in range(3)])[:, None]  # [3 S, 1, k, k]

    def filt(img, w):
        return F.conv2d(img, w, padding=pad, groups=3)

    mux = filt(x, g_masks)
    muy = filt(y, g_masks)
    mux2, muy2, muxy = mux * mux, muy * muy, mux * muy
    sigmax2 = filt(x * x, g_masks) - mux2
    sigmay2 = filt(y * y, g_masks) - muy2
    sigmaxy = filt(x * y, g_masks) - muxy

    lum = (2 * muxy + C1) / (mux2 + muy2 + C1)
    cs = (2 * sigmaxy + C2) / (sigmax2 + sigmay2 + C2)

    lM = lum[:, -1] * lum[:, -2] * lum[:, -3]
    PIcs = torch.prod(cs, dim=1)
    loss_ms_ssim = 1 - lM * PIcs  # [B, H, W]

    loss_l1 = torch.abs(x - y)  # [B, 3, H, W]
    gaussian_l1 = torch.mean(filt(loss_l1, g_masks[-3:]), dim=1)
    loss_mix = alpha * loss_ms_ssim + (1 - alpha) * gaussian_l1 / data_range
    return torch.mean(compensation * loss_mix)
