"""Camera ray generation and NDC projection.

Conventions match the reference exactly:
  * get_rays (utils/run_lushnerf_helpers.py:517-539): pinhole rays with a
    half-pixel offset (HALF_PIX = 0.5), y flipped, looking down -z; ray
    directions rotated to world by c2w[:3,:3]; origin = c2w[:3,-1].
  * ndc_rays (utils/run_lushnerf_helpers.py:542-562): the original NeRF NDC
    projection for forward-facing scenes (near plane shift + projection).
  * get_rays_np: get_rays on the host in numpy, for the data pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

HALF_PIX = 0.5


def get_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Rays through every pixel of an HxW image.

    K: [3,3] intrinsics; c2w: [3,4] pose, both float32 tensors on the
    device the rays should live on.  Returns (rays_o, rays_d), each [H, W, 3].
    """
    dev = c2w.device
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dirs = torch.stack(
        [
            (i + (HALF_PIX - K[0, 2])) / K[0, 0],
            -(j + (HALF_PIX - K[1, 2])) / K[1, 1],
            -torch.ones_like(i),
        ],
        dim=-1,
    )
    # rotate camera-frame dirs to world: sum_k dirs[..., k] * c2w[:3, k]
    # (written out, so no matmul precision mode is involved)
    R = c2w[:3, :3]
    rays_d = dirs[..., 0:1] * R[:, 0] + dirs[..., 1:2] * R[:, 1] + dirs[..., 2:3] * R[:, 2]
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, K, c2w):
    """get_rays in numpy on the host (reference get_rays_np,
    utils/run_lushnerf_helpers.py:531-539), the same arithmetic as the JAX
    package's: the data pipeline builds every training ray with it before
    one upload to the device.  Returns (rays_o, rays_d), each [H, W, 3]."""
    K = np.asarray(K)
    c2w = np.asarray(c2w)
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack(
        [
            (i + (HALF_PIX - K[0, 2])) / K[0, 0],
            -(j + (HALF_PIX - K[1, 2])) / K[1, 1],
            -np.ones_like(i),
        ],
        axis=-1,
    )
    rays_d = np.einsum("hwk,ck->hwc", dirs, c2w[:3, :3])
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Project rays to normalized device coordinates (forward-facing scenes)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
