"""Image quality metrics: MSE / PSNR / SSIM in torch, on the renders'
device.

The metrics of lushnerf_tpu/utils/metrics.py: the reference evaluates via
skimage on CPU after mapping images to [-1, 1] (utils/metrics.py:15-94):
mse = mean squared error, psnr with data_range 2, ssim with skimage
defaults (7x7 uniform window, K1=0.01, K2=0.03, multichannel), and LPIPS
(`utils/lpips.py`: AlexNet with the v0.1 heads, which raises
`LPIPSUnavailable`, a ValueError, without its weights; the trainer then
reports it as nan, as the JAX trainer does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lushnerf_torch.utils import lpips as lpips_lib


def to_pm1(x):
    """[0,1] -> [-1,1], clipped (reference utils/metrics.py:59-61)."""
    return torch.clamp(x * 2.0 - 1.0, -1.0, 1.0)


def mse(im1, im2):
    return torch.mean((to_pm1(im1) - to_pm1(im2)) ** 2)


def psnr(im1, im2, data_range: float = 2.0):
    return 10.0 * torch.log10(data_range**2 / mse(im1, im2))


def _uniform_filter(img, win: int):
    """Mean filter with a win x win window, 'valid' region, per channel.

    img: [H, W, C] -> [H-win+1, W-win+1, C].
    """
    x = img.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
    k = torch.full((1, 1, win, win), 1.0 / (win * win), dtype=img.dtype, device=img.device)
    return F.conv2d(x, k)[:, 0].permute(1, 2, 0)


def ssim(im1, im2, data_range: float = 2.0, win: int = 7, K1: float = 0.01, K2: float = 0.03):
    """Structural similarity, skimage-compatible (uniform window, sample
    covariance), multichannel mean.  im1, im2: [H, W, C] in [0, 1], mapped
    to [-1, 1] as the reference's compute_img_metric does."""
    x = to_pm1(im1).float()
    y = to_pm1(im2).float()
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win * win
    cov_norm = NP / (NP - 1)

    ux = _uniform_filter(x, win)
    uy = _uniform_filter(y, win)
    uxx = _uniform_filter(x * x, win)
    uyy = _uniform_filter(y * y, win)
    uxy = _uniform_filter(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux**2 + uy**2 + C1, vx + vy + C2
    return torch.mean((A1 * A2) / (B1 * B2))


METRICS = {"mse": mse, "psnr": psnr, "ssim": ssim, "lpips": lpips_lib.lpips}


def compute_img_metric(im1, im2, metric: str) -> float:
    """Reference-compatible entry point over [0,1] images [H, W, C] or
    [N, H, W, C] (tensors, or arrays put on the CPU): the mean over the
    images, one host read."""
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r} not recognized (have {sorted(METRICS)})")
    im1 = torch.as_tensor(im1)
    im2 = torch.as_tensor(im2, device=im1.device)
    if im1.ndim == 3:
        im1, im2 = im1[None], im2[None]
    vals = torch.stack([METRICS[metric](a, b) for a, b in zip(im1, im2)])
    return float(vals.sum() / len(vals))
