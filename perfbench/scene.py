"""The scene of every cell, made in numpy from a seed: chip_smoke.py's
synthetic pattern at the size the configuration file gives.

A forward-facing capture: `views` cameras on a grid of small offsets, all
looking down -z with the identity rotation, each seeing a smooth coloured
pattern that shifts with the camera, plus a little noise.  Every seed gives
the same sizes; only the values differ.
"""

from __future__ import annotations

import numpy as np


def make_scene(seed: int, views: int, height: int, width: int, focal: float,
               with_images: bool = True) -> dict:
    """Trainer's `data=` dict: images [N, H, W, 3] f32 in [0, 1] (None
    without them), poses [N, 3, 4], bds [N, 2], render_poses (the poses),
    hwf."""
    rng = np.random.default_rng(seed)
    freq = rng.uniform(3.0, 9.0, (3, 2)).astype(np.float32)
    phase = rng.uniform(0.0, 2 * np.pi, 3).astype(np.float32)
    i = np.arange(views)
    dx = (0.04 * (i % 6 - 2.5)).astype(np.float32)
    dy = (0.04 * (i // 6 - 2.0)).astype(np.float32)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (views, 1, 1))
    poses[:, 0, 3], poses[:, 1, 3] = dx, dy
    images = None
    if with_images:
        scale = 1.0 / max(height, width)
        yy = (np.arange(height, dtype=np.float32) * scale)[None, :, None]
        xx = (np.arange(width, dtype=np.float32) * scale)[None, None, :]
        images = np.empty((views, height, width, 3), np.float32)
        for c in range(3):
            sx = np.sin(freq[c, 0] * (xx + 0.1 * dx[:, None, None]) + phase[c])
            cy = np.cos(freq[c, 1] * (yy - 0.1 * dy[:, None, None]))
            images[..., c] = 0.35 + 0.25 * sx * cy
        images += 0.02 * rng.standard_normal(images.shape, dtype=np.float32)
        np.clip(images, 0.0, 1.0, out=images)
    return dict(images=images, poses=poses,
                bds=np.tile(np.array([[1.0, 5.0]], np.float32), (views, 1)),
                render_poses=poses, hwf=(height, width, float(focal)))


def intrinsics(height: int, width: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, 0.5 * width], [0, focal, 0.5 * height], [0, 0, 1]], np.float32)
