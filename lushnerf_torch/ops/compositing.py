"""Alpha compositing of raw MLP outputs along rays.

Matches the reference's (nonstandard) raw2outputs exactly
(models/lushnerf.py:296-352):
  * dists are the N-1 interval lengths (NO 1e10 far pad), scaled by |rays_d|
  * rgb = rgb_activate(raw[..., :3]) over ALL N samples
  * density = sigma_activate(raw[..., :-1, 3] + noise) over the first N-1
    samples only
  * alpha over N-1 intervals, then a terminator alpha == 1 is appended, so
    the final sample absorbs all remaining transmittance
  * weights = alpha * cumprod([1, 1-alpha+1e-10])[:-1]
  * optional near-plane density zeroing at inference
    (render_rmnearplane, models/lushnerf.py:331-335)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from lushnerf_torch.utils.trace import span_backward


class CompositeOut(NamedTuple):
    rgb: torch.Tensor  # [..., 3]
    density: torch.Tensor  # [..., N-1]
    acc: torch.Tensor  # [...]
    weights: torch.Tensor  # [..., N]
    depth: torch.Tensor  # [...]


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    rgb_activate: Callable,
    sigma_activate: Callable,
    density_noise: Optional[torch.Tensor] = None,
    rm_nearplane: float = 0.0,
    white_bkgd: bool = False,
) -> CompositeOut:
    """Composite raw [..., N, 4] predictions into per-ray outputs."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]  # [..., N-1]
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = rgb_activate(raw[..., :3])  # [..., N, 3]

    sigma_raw = raw[..., :-1, 3]
    if density_noise is not None:
        sigma_raw = sigma_raw + density_noise
    density = sigma_activate(sigma_raw)  # [..., N-1]

    if rm_nearplane > 0:
        mask = (z_vals[..., 1:] > rm_nearplane / 128.0).to(density.dtype)
        density = density * mask

    alpha = 1.0 - torch.exp(-density * dists)  # [..., N-1]
    alpha = torch.cat([alpha, torch.ones_like(alpha[..., :1])], dim=-1)  # [..., N]

    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1),
        dim=-1,
    )
    # torch's cumprod backward asks the host whether the input holds a zero
    span_backward(trans, "sync.cumprod_backward")
    trans = trans[..., :-1]
    weights = alpha * trans  # [..., N]

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return CompositeOut(rgb_map, density, acc_map, weights, depth_map)
