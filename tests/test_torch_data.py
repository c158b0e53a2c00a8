"""The port's data pipeline (lushnerf_torch/data/, ops/rays.get_rays_np,
utils/images.py) against lushnerf_tpu's, which is numpy and cv2 only (no
JAX compile): the pose math, get_rays_np, the ray dataset and three
epochs of its batches, and load_llff_data on a scene written to disk,
all bit for bit; the grey image exactly and the frequency masks, which
may differ from cv2's only at a pixel whose normalised magnitude lies
within 1e-3 of the threshold (the port's DFT is float64, cv2's float32);
and the PNG writer against imageio's reader, bit for bit.
"""

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import cv2

from lushnerf_tpu.data import freq_mask as jfreq
from lushnerf_tpu.data import llff as jllff
from lushnerf_tpu.data import rays as jrays
from lushnerf_tpu.ops import rays as jops_rays
from lushnerf_torch.data import freq_mask, llff, need
from lushnerf_torch.data import rays as trays
from lushnerf_torch.ops import rays as tops_rays
from lushnerf_torch.utils.images import png_bytes, write_png

MASK_MARGIN = 1e-3  # normalised magnitude units (0-255) around the threshold


def random_poses(rng, n, hwf=(24.0, 32.0, 30.0)):
    """Forward-facing [N, 3, 5] camera poses (c2w columns and hwf)."""
    poses = []
    for _ in range(n):
        fwd = rng.standard_normal(3)
        fwd[2] = abs(fwd[2]) + 1.0
        fwd /= np.linalg.norm(fwd)
        up_hint = np.array([0.0, 1.0, 0.0]) + 0.2 * rng.standard_normal(3)
        right = np.cross(up_hint, fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        t = rng.standard_normal(3) * 0.5 + np.array([0, 0, 4.0])
        poses.append(np.stack([right, up, fwd, t, np.asarray(hwf)], 1))
    return np.stack(poses).astype(np.float32)


def smooth_images(rng, n, H, W):
    """uint8 RGB views: smooth bands plus noise, dark as low-light input."""
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        img = np.stack([60 + 40 * np.sin(xx / (3.0 + c) + 0.7 * i + c) * np.cos(yy / 5.0)
                        for c in range(3)], -1)
        out.append(img + 12 * rng.standard_normal((H, W, 3)))
    return np.clip(np.stack(out), 0, 255).astype(np.uint8)


def write_llff_scene(root, n=4, H=24, W=32, seed=0):
    """An LLFF scene: images/NNN.png and poses_bounds.npy ([N, 17]: the 3x5
    pose in LLFF axis order, rows (-c2w row 1, c2w row 0, c2w row 2), and
    near / far)."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    for i, img in enumerate(smooth_images(rng, n, H, W)):
        imageio.imwrite(root / "images" / f"{i:03d}.png", img)
    c2w = random_poses(rng, n, hwf=(H, W, 0.9 * W))
    llff_rows = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2]], axis=1)  # [N, 3, 5]
    bds = np.stack([rng.uniform(1.0, 1.5, n), rng.uniform(5.0, 6.0, n)], -1)
    np.save(root / "poses_bounds.npy",
            np.concatenate([llff_rows.reshape(n, 15), bds], -1).astype(np.float64))
    return root


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# pose math and rays
# ---------------------------------------------------------------------------


def test_poses_avg_and_recenter_exact():
    poses = random_poses(np.random.default_rng(1), 7)
    _equal(llff.poses_avg(poses), jllff.poses_avg(poses))
    _equal(llff.recenter_poses(poses.copy()), jllff.recenter_poses(poses.copy()))


def test_render_paths_exact():
    poses = random_poses(np.random.default_rng(2), 6)
    c2w = jllff.poses_avg(poses)
    up = poses[:, :3, 1].sum(0) / np.linalg.norm(poses[:, :3, 1].sum(0))
    rads = np.array([0.3, 0.2, 0.1])
    _equal(llff.render_path_spiral(c2w, up, rads, 3.0, 0.5, 2, 11),
           jllff.render_path_spiral(c2w, up, rads, 3.0, 0.5, 2, 11))
    _equal(llff.render_path_epi(c2w, up, 0.15, 9), jllff.render_path_epi(c2w, up, 0.15, 9))


def test_spherify_exact():
    rng = np.random.default_rng(3)
    poses = random_poses(rng, 8)
    bds = rng.uniform(1.0, 6.0, (8, 2)).astype(np.float32)
    for g, w in zip(llff.spherify_poses(poses.copy(), bds.copy()),
                    jllff.spherify_poses(poses.copy(), bds.copy())):
        _equal(g, w)
    assert llff.DEFAULT_BD_FACTOR == jllff.DEFAULT_BD_FACTOR


@pytest.mark.parametrize("H,W", [(5, 7), (16, 16)])
def test_get_rays_np_exact(H, W):
    K = np.array([[11.0, 0, W / 2], [0, 12.0, H / 2], [0, 0, 1]], np.float32)
    c2w = random_poses(np.random.default_rng(4), 1)[0, :, :4]
    for g, w in zip(tops_rays.get_rays_np(H, W, K, c2w), jops_rays.get_rays_np(H, W, K, c2w)):
        _equal(g, w)
    assert tops_rays.HALF_PIX == jops_rays.HALF_PIX


def _dataset_inputs(rng, n=3, H=4, W=5):
    images = rng.random((n, H, W, 3), dtype=np.float32)
    poses = random_poses(rng, n)[:, :, :4]
    K = np.array([[7.0, 0, W / 2], [0, 7.0, H / 2], [0, 0, 1]], np.float32)
    fq = rng.integers(0, 2, (n, H, W)).astype(np.uint8)
    return images, poses, K, fq, np.array([0, 2, 5])


@pytest.mark.parametrize("full_hw", [None, (8, 10)], ids=["own-res", "downsampled"])
def test_ray_dataset_and_three_epochs_of_batches_exact(full_hw):
    """The dataset's tensors and every batch over three epochs of 60 rays
    in batches of 16 (three each, then a reshuffle: the last 12 rays of
    an epoch are never served, as in lushnerf_tpu), from one seed.  The
    port keeps every field but the pixel coordinates (rays_x / rays_y,
    which full_hw scales), which only the unported consistency loss
    reads."""
    images, poses, K, fq, ids = _dataset_inputs(np.random.default_rng(5))
    got = trays.build_ray_dataset(images, poses, K, fq, ids, device="cpu")
    want = jrays.build_ray_dataset(images, poses, K, fq, ids, full_hw=full_hw)
    assert len(got) == len(want) == 60
    for k in trays.FIELDS:
        _equal(getattr(got, k), getattr(want, k))
    rng_g, rng_w = np.random.default_rng(9), np.random.default_rng(9)
    got.shuffle(rng_g)
    want.shuffle(rng_w)
    for _ in range(9):
        bg, bw = got.next_batch(16, rng_g), want.next_batch(16, rng_w)
        assert list(bg) == [k for k in bw if k not in ("rays_x", "rays_y")]
        for k in bg:
            _equal(bg[k], bw[k])
    # the two streams drew the same numbers: they stand at the same state
    assert rng_g.bit_generator.state == rng_w.bit_generator.state


# ---------------------------------------------------------------------------
# the loader on a scene on disk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor,spherify,path_epi",
                         [(None, False, False), (2, True, False), (None, False, True)],
                         ids=["full-res", "factor2-spherify", "epi"])
def test_load_llff_data_exact(tmp_path, factor, spherify, path_epi):
    """Each loader reads its own copy of the scene, so each writes (and
    reads) its own preprocessed (CLAHE 10) and minified images."""
    kw = dict(factor=factor, spherify=spherify, path_epi=path_epi, gamma=1.0, clahe=10,
              render_focuspoint_scale=3.0, render_radius_scale=0.9)
    got = llff.load_llff_data(write_llff_scene(tmp_path / "port"), **kw)
    want = jllff.load_llff_data(write_llff_scene(tmp_path / "jax"), **kw)
    assert got.i_test == want.i_test
    for name in ("images", "poses", "bds", "render_poses"):
        _equal(getattr(got, name), getattr(want, name))
    sfx = f"_{factor}" if factor else ""
    pre = sorted(p.name for p in (tmp_path / "port" / f"images{sfx}_preprocess").iterdir())
    assert pre == [f"{i:03d}.png" for i in range(4)]


def test_need_names_the_missing_package():
    with pytest.raises(ImportError, match="no_such_codec"):
        need("no_such_codec")
    assert need("cv2") is cv2


# ---------------------------------------------------------------------------
# frequency masks
# ---------------------------------------------------------------------------


def test_gray_exact_at_every_uint8_triple_of_a_grid():
    v = np.arange(0, 256, 3, dtype=np.uint8)
    img = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(1, -1, 3)
    _equal(freq_mask.rgb_to_gray_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("H,W,radius", [(24, 32, 8), (33, 31, 5), (16, 16, 50), (60, 45, 30)])
def test_frequency_mask_against_cv2(H, W, radius):
    """Every pixel equal to cv2's mask but where the normalised magnitude
    lies within MASK_MARGIN of 48; the batched masks equal the single."""
    images = smooth_images(np.random.default_rng(H + W), 3, H, W)
    masks = freq_mask.get_masks_for_images(images, radius)
    want = jfreq.get_masks_for_images(images, radius)
    assert masks.dtype == want.dtype == np.uint8
    norm = freq_mask.normalized_magnitude(freq_mask.rgb_to_gray_u8(images), radius).numpy()
    differ = masks != want
    assert np.all(np.abs(norm[differ] - freq_mask.THRESHOLD) <= MASK_MARGIN), norm[differ]
    assert 0.05 < want.mean() < 0.95  # the threshold cuts these images
    for img, m in zip(images, masks):
        single = freq_mask.frequency_mask(img, radius)
        assert single.dtype == np.float32
        _equal(single.astype(np.uint8), m)


# ---------------------------------------------------------------------------
# the PNG writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 5, 3), (9, 4), (1, 1, 3), (13, 6, 1)],
                         ids=["rgb", "grey", "one-pixel", "grey-channel"])
def test_png_writer_against_imageio(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(path, img)
    back = imageio.imread(path)
    _equal(back, img.reshape(img.shape[:2] + ((3,) if img.ndim == 3 and img.shape[2] == 3 else ())))


def test_png_writer_rejects_other_dtypes():
    with pytest.raises(TypeError):
        png_bytes(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError):
        png_bytes(np.zeros((2, 2, 4), np.uint8))
