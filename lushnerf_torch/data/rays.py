"""Train-time ray dataset on the device: all rays of the training views,
one permutation an epoch, sequential N_rand slices.

The dataset of lushnerf_tpu/data/rays.py (the reference trainer's inline
build, run_lushnerf.py:559-614) with its tensors on the device:
  * rays from get_rays_np per train view -> [N*H*W, 3, 2] (o, d stacked
    last), built on the host in numpy and uploaded once
  * target colors, frequency-mask bits, image indices
  * each epoch's permutation drawn on the host with the numpy Generator
    calls of the JAX package's RayDataset (so the batches are its batches,
    bit for bit), uploaded once an epoch; a batch is one device
    index_select per tensor, with no host gather and no copy per step.
The JAX dataset's pixel coordinates (rays_x / rays_y) are left out: only
the cross-view consistency loss reads them, and it is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lushnerf_torch.ops.rays import get_rays_np

FIELDS = ("rays", "rgbs", "fq_mask", "images_idx")


class RayDataset:
    """rays [T, 3, 2] f32, rgbs [T, 3] f32, fq_mask [T] uint8, images_idx
    [T, 1] int32, all on one device."""

    def __init__(self, rays, rgbs, fq_mask, images_idx):
        self.rays, self.rgbs, self.fq_mask, self.images_idx = rays, rgbs, fq_mask, images_idx
        self._order: Optional[torch.Tensor] = None
        self._cursor = 0

    def __len__(self):
        return self.rays.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rays.device

    def shuffle(self, rng: np.random.Generator):
        order = torch.from_numpy(rng.permutation(len(self)))
        if self.device.type == "cuda":  # from pinned memory, without waiting for the queue
            order = order.pin_memory()
        self._order = order.to(self.device, non_blocking=True)
        self._cursor = 0

    def next_batch(self, n: int, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        """Sequential slice of the current permutation; reshuffles on epoch
        end (reference reshuffles and restarts, run_lushnerf.py:610-614)."""
        if self._order is None or self._cursor + n > len(self):
            self.shuffle(rng)
        idx = self._order[self._cursor : self._cursor + n]
        self._cursor += n
        return {k: getattr(self, k).index_select(0, idx) for k in FIELDS}


def build_ray_dataset(
    images: np.ndarray,  # [N, H, W, 3] float32 train images (already indexed)
    poses: np.ndarray,  # [N, 3, 4] train poses
    K: np.ndarray,  # [3, 3] intrinsics at the image resolution
    fq_masks: np.ndarray,  # [N, H, W]
    image_indices: np.ndarray,  # [N] global image ids (for the RBK embedding)
    device: str | torch.device = "cpu",
) -> RayDataset:
    hei, wid = images.shape[1:3]

    rays_list = []
    for p in poses[:, :3, :4]:
        ro, rd = get_rays_np(hei, wid, K, p)
        rays_list.append(np.stack([ro, rd], axis=-1))  # [H, W, 3, 2]
    rays = np.stack(rays_list, 0).reshape(-1, 3, 2).astype(np.float32)

    rgbs = images.reshape(-1, 3).astype(np.float32)
    fq = fq_masks.reshape(-1)
    idx = np.repeat(image_indices.astype(np.int32), hei * wid).reshape(-1, 1)

    arrays = dict(rays=rays, rgbs=rgbs, fq_mask=fq, images_idx=idx)
    return RayDataset(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                         for k, v in arrays.items()})
