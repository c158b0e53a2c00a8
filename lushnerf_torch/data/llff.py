"""LLFF forward-facing dataset loader.

A copy of lushnerf_tpu/data/llff.py, which covers the reference's data
path (data_utils/load_llff.py):
  * poses_bounds.npy parsing ([N, 17] -> poses [3,5,N] + bds [2,N], :146-149)
  * factor-based image minification (:8-57), with cv2 INTER_AREA
  * low-light preprocessing cache (`images{sfx}_preprocess`, :164-171)
  * axis correction [-y x z], bd rescale by 1/(bds.min()*bd_factor),
    pose recentering (:262-273), optional spherify (:279-334)
  * spiral / epi render-path generation (:234-259)
  * holdout view selection (closest-to-average pose, :400-402)

The pose math is numpy.  PNGs are read by the port's own reader
(`utils/images.read_png`, zlib and numpy), so a scene whose images and
`_preprocess` cache are PNGs loads without an image package; JPEGs need
`imageio`, and minifying or preprocessing needs `cv2`, each imported where
it is used.  `write_llff_scene` writes an in-memory scene as such a
directory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from lushnerf_torch.data import need
from lushnerf_torch.data.preprocess import preprocessed_dir
from lushnerf_torch.utils.images import png_bytes, read_png


# ---------------------------------------------------------------------------
# Pose math.  Numeric conventions follow the public LLFF/NeRF lineage the
# reference inherits (data_utils/load_llff.py:205-334) -- camera frames are
# [right, up, forward, origin] columns with right = up x forward -- batch-
# vectorized, with analytic rigid inverses instead of generic 4x4 inverses.
# ---------------------------------------------------------------------------


def _unit(v, axis=-1):
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def _normalize(x):
    return x / np.linalg.norm(x)


def _camera_frames(forward, up, origin):
    """Orthonormal c2w frame(s) from viewing direction(s) and an up hint.

    forward, origin: [..., 3]; up: [3] or [..., 3] (broadcast).  Columns:
    right = unit(up x fwd), true_up = unit(fwd x right), fwd, origin.
    Returns [..., 3, 4]; fully batched over leading axes.
    """
    fwd = _unit(np.asarray(forward, np.float64))
    up_b = np.broadcast_to(np.asarray(up, np.float64), fwd.shape)
    right = _unit(np.cross(up_b, fwd))
    true_up = _unit(np.cross(fwd, right))
    origin_b = np.broadcast_to(np.asarray(origin, np.float64), fwd.shape)
    return np.stack([right, true_up, fwd, origin_b], axis=-1)


def _rigid_apply_inverse(frame, poses_r, poses_t):
    """Apply the inverse of an orthonormal [3, 4] frame to pose batches.

    Equivalent to inv(frame_as_4x4) @ pose (for rigid frames R^-1 = R^T),
    without materializing 4x4s: returns (R^T @ poses_r, R^T (poses_t - t)).
    """
    rot, t = frame[:, :3], frame[:, 3]
    new_r = np.einsum("ji,njk->nik", rot, poses_r)
    new_t = np.einsum("ji,nj->ni", rot, poses_t - t)
    return new_r, new_t


def poses_avg(poses):
    """Mean camera pose [3, 5]: mean origin, summed forward/up axes."""
    frame = _camera_frames(
        poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0), poses[:, :3, 3].mean(0)
    )
    return np.concatenate([frame, poses[0, :3, -1:]], 1)


def recenter_poses(poses):
    """Re-express all poses relative to their average (world = avg cam)."""
    out = poses + 0
    avg = poses_avg(poses)[:, :4]
    out[:, :3, :3], out[:, :3, 3] = _rigid_apply_inverse(
        avg, poses[:, :3, :3], poses[:, :3, 3]
    )
    return out


def render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    """Spiral of N camera poses around the average pose, all angles at once.

    Cameras orbit on an ellipse of radii `rads` (with z wobble at `zrate`),
    each looking at the point `focal` units down the average view axis.
    Returns [N, 3, 5].
    """
    rads4 = np.append(np.asarray(rads, np.float64)[:3], 1.0)
    theta = np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]
    offsets = (
        np.stack(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), np.ones_like(theta)],
            axis=-1,
        )
        * rads4
    )  # [N, 4] homogeneous, in the avg-camera frame
    centers = offsets @ c2w[:3, :4].T  # [N, 3]
    focus = c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
    frames = _camera_frames(centers - focus, up, centers)
    hwf = np.broadcast_to(c2w[:3, 4:5], (N, 3, 1))
    return np.concatenate([frames, hwf], axis=-1)


def render_path_epi(c2w, up, rads, N):
    """Epipolar sweep: N cameras translated along the avg-frame x axis,
    constant forward direction.  (The homogeneous 1 is scaled by `rads`
    too — reference quirk kept: the sweep center is rads * avg origin.)
    Returns [N, 3, 5]."""
    theta = np.linspace(-1.0, 1.0, N + 1)[:-1]
    offsets = np.stack(
        [theta, np.zeros_like(theta), np.zeros_like(theta), np.ones_like(theta)], axis=-1
    ) * float(rads)
    centers = offsets @ c2w[:3, :4].T
    fwd = np.broadcast_to(c2w[:3, 2], centers.shape)
    frames = _camera_frames(fwd, up, centers)
    hwf = np.broadcast_to(c2w[:3, 4:5], (N, 3, 1))
    return np.concatenate([frames, hwf], axis=-1)


def _nearest_point_to_axes(origins, dirs):
    """Least-squares point closest to all camera view axes.

    Solves min_x sum_i |P_i (x - o_i)|^2 with P_i = I - d_i d_i^T, the
    projector off axis i; normal equations mean(P_i^T P_i) x = mean(P_i^T P_i o_i).
    origins, dirs: [N, 3] (dirs unit).
    """
    proj = np.eye(3) - dirs[:, :, None] * dirs[:, None, :]  # [N, 3, 3]
    ata = np.einsum("nji,njk->nik", proj, proj).mean(0)
    atb = np.einsum("nji,njk,nk->i", proj, proj, origins) / len(origins)
    return np.linalg.solve(ata, atb)


def spherify_poses(poses, bds):
    """Recenter on the axis-convergence point, scale to unit radius, and
    generate a 120-pose circular render path at the cameras' mean height."""
    center = _nearest_point_to_axes(poses[:, :3, 3], poses[:, :3, 2])
    up = (poses[:, :3, 3] - center).mean(0)

    # world frame with z = up hint (the [.1,.2,.3] tie-breaker fixes the
    # in-plane rotation); columns ordered [vec1, vec2, vec0] as in the
    # LLFF convention so +z of the new world is the scene's up
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    world = np.stack([vec1, vec2, vec0, center], 1)  # [3, 4] orthonormal

    reset_r, reset_t = _rigid_apply_inverse(world, poses[:, :3, :3], poses[:, :3, 3])
    rad = np.sqrt(np.mean(np.sum(np.square(reset_t), -1)))
    sc = 1.0 / rad
    reset_t = reset_t * sc
    bds = bds * sc
    rad *= sc

    zh = reset_t[:, 2].mean()
    radcircle = np.sqrt(rad**2 - zh**2)
    th = np.linspace(0.0, 2.0 * np.pi, 120)
    camorigin = np.stack(
        [radcircle * np.cos(th), radcircle * np.sin(th), np.full_like(th, zh)], axis=-1
    )
    # the circle path uses the mirrored frame [fwd x up, fwd x (fwd x up)]
    # (reference convention for this path: both in-plane axes negated
    # relative to _camera_frames)
    fwd = _unit(camorigin)
    vec0c = _unit(np.cross(fwd, np.array([0.0, 0.0, -1.0])))
    vec1c = _unit(np.cross(fwd, vec0c))
    new_poses = np.stack([vec0c, vec1c, fwd, camorigin], axis=-1)  # [120, 3, 4]

    hwf = poses[0, :3, -1:]
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(hwf, new_poses[:, :3, :1].shape)], -1
    )
    poses_reset = np.concatenate(
        [reset_r, reset_t[:, :, None], np.broadcast_to(hwf, (len(poses), 3, 1))], -1
    )
    return poses_reset.astype(poses.dtype), new_poses.astype(poses.dtype), bds


def _minify(basedir: Path, factor: int) -> Path:
    """Downscale images/ by `factor` into images_{factor}/ (cached), with
    cv2 INTER_AREA resampling, writing pngs (the reference shells out to
    ImageMagick mogrify, :8-57)."""
    out = basedir / f"images_{factor}"
    if out.exists():
        return out
    cv2 = need("cv2")
    src = basedir / "images"
    files = [f for f in sorted(os.listdir(src)) if f.lower().endswith(("jpg", "jpeg", "png"))]
    out.mkdir(parents=True)
    for f in files:
        img = cv2.imread(str(src / f), cv2.IMREAD_COLOR)
        h, w = img.shape[:2]
        img = cv2.resize(img, (int(round(w / factor)), int(round(h / factor))), interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(out / (Path(f).stem + ".png")), img)
    return out


def _imread(path: str) -> np.ndarray:
    if path.lower().endswith("png"):
        return read_png(path)
    return need("imageio.v2").imread(path)


def write_llff_scene(basedir: str | Path, images: np.ndarray, c2w: np.ndarray, bds: np.ndarray,
                     focal: float, filters=0, cache_filters=None) -> Path:
    """An in-memory scene as an LLFF directory that `load_llff_data` reads
    without an image package: images [N, H, W, 3] uint8 as
    `images/NNN.png` with the PNG row filters `filters` (see
    `utils.images.png_bytes`) and the same images in `images_preprocess/`
    (the preprocess cache, so the images are taken as preprocessed) with
    `cache_filters` (default `filters`), and `poses_bounds.npy` [N, 17]
    from c2w [N, 3, 4] (columns right, up, back, position), bds [N, 2] and
    the focal, in LLFF's column order [-up, right, back, position, hwf]
    that the loader turns back."""
    basedir = Path(basedir)
    images = np.asarray(images)
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"write_llff_scene: uint8 images [N, H, W, C] expected, "
                         f"got {images.dtype} {images.shape}")
    n, h, w = images.shape[:3]
    c2w = np.asarray(c2w, np.float64)
    hwf = np.broadcast_to(np.array([h, w, focal], np.float64)[:, None], (n, 3, 1))
    poses = np.concatenate([-c2w[:, :, 1:2], c2w[:, :, 0:1], c2w[:, :, 2:4], hwf], axis=2)
    basedir.mkdir(parents=True, exist_ok=True)
    np.save(basedir / "poses_bounds.npy",
            np.concatenate([poses.reshape(n, 15), np.asarray(bds, np.float64)], 1))
    subs = {"images": filters, "images_preprocess": filters if cache_filters is None else cache_filters}
    for sub, filt in subs.items():
        (basedir / sub).mkdir(exist_ok=True)
        for i, img in enumerate(images):
            (basedir / sub / f"{i:03d}.png").write_bytes(png_bytes(img, filt))
    return basedir


class LLFFData(NamedTuple):
    images: np.ndarray  # [N, H, W, 3] float32 in [0,1] (preprocessed)
    poses: np.ndarray  # [N, 3, 5] (with hwf column)
    bds: np.ndarray  # [N, 2]
    render_poses: np.ndarray  # [P, 3, 5]
    i_test: int


# world-scale rescale factor 1/(bds.min()*DEFAULT_BD_FACTOR) applied by the
# loader (run_lushnerf.py passes bd_factor=.75).  Anything that converts
# raw scene units (e.g. stored synthetic depth maps) into the trainer's
# world frame uses this constant.
DEFAULT_BD_FACTOR = 0.75


def load_llff_data(
    basedir: str | Path,
    factor: int | None = None,
    recenter: bool = True,
    bd_factor: float | None = DEFAULT_BD_FACTOR,
    spherify: bool = False,
    path_epi: bool = False,
    gamma: float = 1.0,
    clahe: float = 15,
    render_focuspoint_scale: float = 1.0,
    render_radius_scale: float = 1.0,
    preprocess: bool = True,
) -> LLFFData:
    basedir = Path(basedir)
    poses_arr = np.load(basedir / "poses_bounds.npy")
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    if factor is not None and factor != 1:
        imgdir = _minify(basedir, factor)
        sc_factor = factor
    else:
        imgdir = basedir / "images"
        if not imgdir.exists() and (basedir / "images_1").exists():
            imgdir = basedir / "images_1"
        sc_factor = 1

    if preprocess:
        imgdir = preprocessed_dir(imgdir, gamma, clahe)

    imgfiles = [
        str(imgdir / f)
        for f in sorted(os.listdir(imgdir))
        if f.lower().endswith(("jpg", "jpeg", "png"))
    ]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

    sh = _imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / sc_factor

    imgs = np.stack([_imread(f)[..., :3] / 255.0 for f in imgfiles], 0)

    # axis correction: [-y x z] -> [x -y z] ordering fix (:342)
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)
    images = imgs.astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        focal = focal * render_focuspoint_scale
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        rads[0] *= render_radius_scale
        rads[1] *= render_radius_scale
        N_views, N_rots = 120, 2
        render_poses = render_path_spiral(c2w, up, rads, focal, zrate=0.5, rots=N_rots, N=N_views)
        if path_epi:
            rads[0] = rads[0] / 2
            render_poses = render_path_epi(c2w, up, rads[0], N_views)

    render_poses = np.array(render_poses).astype(np.float32)

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return LLFFData(images, poses, bds, render_poses, i_test)
