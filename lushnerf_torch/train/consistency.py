"""Multi-view consistency (CTE) pass: the aligned-pixel render.

Reference (models/lushnerf.py:949-988 + run_lushnerf.py:629-650): each
iteration from `noisenerf_start_iter` on, pick a random anchor view and 32
random match columns; in every training view, render the pixels matched to
those columns through the *sharp* branch (no blur kernel, no noise head,
fine rgb before the tone map); the loss (`losses.consistency_loss`) then
penalises each confident view's colour against the confidence-masked mean.

The anchor and columns are drawn on the host from the match tables
(`matcher.api.MatchTables.sample_anchor`); this pass receives the
[V, n_pix, ...] slice on the device and renders all V * n_pix rays in one
call, through the scene MLPs' fused path where the config routes them
there (K1 forward, K2/K3 backward).
"""

from __future__ import annotations

import torch

from lushnerf_torch.models.lushnerf import LushConfig, LushNeRF
from lushnerf_torch.models.renderer import prepare_rays, render_rays_scene
from lushnerf_torch.ops.rays import HALF_PIX


def rays_at_pixels(K: torch.Tensor, c2w: torch.Tensor, pix_xy: torch.Tensor, H: int, W: int):
    """Rays through integer pixel coords (x, y) of each view.

    K: [3, 3]; c2w: [V, 3, 4]; pix_xy: [V, N, 2] (float pixel coords,
    clamped to the image, then floored to the pixel whose centre the ray
    goes through: indexing the full get_rays grid at [y, x],
    models/lushnerf.py:974-983).  Returns (rays_o, rays_d), each [V, N, 3].
    """
    x = torch.floor(torch.clamp(pix_xy[..., 0], 0, W - 1).float())
    y = torch.floor(torch.clamp(pix_xy[..., 1], 0, H - 1).float())
    dirs = torch.stack(
        [
            (x + (HALF_PIX - K[0, 2])) / K[0, 0],
            -(y + (HALF_PIX - K[1, 2])) / K[1, 1],
            -torch.ones_like(x),
        ],
        dim=-1,
    )
    # rotate to world: sum_k dirs[..., k] * c2w[:3, k], written out as
    # ops/rays.get_rays does (no matmul precision mode is involved)
    R = c2w[:, None, :3, :3]
    rays_d = dirs[..., 0:1] * R[..., 0] + dirs[..., 1:2] * R[..., 1] + dirs[..., 2:3] * R[..., 2]
    rays_o = c2w[:, None, :3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def render_aligned_pixels(
    model: LushNeRF,
    cfg: LushConfig,
    H: int,
    W: int,
    K: torch.Tensor,
    poses: torch.Tensor,
    align_pix: torch.Tensor,
) -> torch.Tensor:
    """Render the matched pixels of every view through the sharp branch.

    poses: [V, 3, 4] train poses; align_pix: [V, n_pix, 2] matched pixel
    coords per view.  Eval-style sampling (no stratified jitter, the
    deterministic importance samples, no density noise), but with the
    near-plane mask off (inference=False: the reference's module stays in
    training mode).  The rays carry no gradient; the scene MLPs do.
    Returns the fine rgb before the tone map, [V, n_pix, 3].
    """
    V, n_pix = align_pix.shape[0], align_pix.shape[1]
    with torch.no_grad():
        rays_o, rays_d = rays_at_pixels(K, poses, align_pix, H, W)
    rays_o = rays_o.reshape(V * n_pix, 3)
    rays_d = rays_d.reshape(V * n_pix, 3)
    prepared = prepare_rays(cfg.render, H, W, K[0, 0], rays_o, rays_d, cfg.near, cfg.far)
    out = render_rays_scene(
        model.mlp_coarse, model.mlp_fine, cfg.mlp_cfg, cfg.render, prepared, inference=False,
    )
    return out["rgb"].reshape(V, n_pix, 3)
