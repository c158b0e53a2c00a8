"""Matcher interface and the correspondence tables of the CTE loss.

Reference behaviour (run_lushnerf.py:291-292, 745-774): every 20k
iterations the frozen DKMv3 matcher runs over every ordered pair of
*rendered* training views at 640x1120; per pair it stores, for every pixel
column of the first W columns, the matched keypoints of both views
(`Align_Matrix[k, v, :, :4] = [x0, y0, x1, y1]`) and a certainty
(`Align_Mask`).

The tables live on the host as numpy, as lushnerf_tpu keeps them: each
consist iteration draws one anchor view and 32 columns with a numpy
`Generator` (so the draws are the JAX package's bits) and uploads only the
[V, 32, 2] + [V, 32] slice it gathered.  Pure numpy, a copy of
lushnerf_tpu/matcher/api.py (the port imports nothing of that package)
whose `save` writes its .npz uncompressed, plus `nearest_resize` and
`load_gt_depths` for `matcher = gt`.  The matchers:

  * `GridStubMatcher` -- identity grid at constant certainty (`stub`)
  * `GroundTruthMatcher` -- geometry-exact matches from depth maps (`gt`)
  * `PrecomputedMatcher` -- tables from an .npz (`precomputed`)
  * `lushnerf_torch.matcher.dkm.DKMMatcher` -- the DKMv3 port (`dkm`)
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple

import numpy as np


@dataclasses.dataclass
class MatchTables:
    """Dense correspondences between all ordered train-view pairs.

    kpts: [V, V, P, 4] float32 — (x0, y0, x1, y1) per column, pixel coords.
    certainty: [V, V, P] float32.
    The reference's P is H*W of the match resolution; P here is whatever
    the matcher produced (columns are sampled uniformly at train time
    either way).
    """

    kpts: np.ndarray
    certainty: np.ndarray

    @property
    def num_views(self) -> int:
        return self.kpts.shape[0]

    @property
    def num_columns(self) -> int:
        return self.kpts.shape[2]

    def sample_anchor(self, rng: np.random.Generator, n_pix: int):
        """Pick a random anchor view + n_pix random columns; return the
        per-view matched pixel coords and certainties
        (Render_Aligned_Pixel, models/lushnerf.py:959-967)."""
        anchor = int(rng.integers(0, self.num_views))
        cols = rng.integers(0, self.num_columns, size=n_pix)
        kp = self.kpts[anchor][:, cols]  # [V, n_pix, 4]
        cert = self.certainty[anchor][:, cols]  # [V, n_pix]
        # pixel coords in each target view are the second keypoint pair
        return anchor, kp[..., 2:4], cert

    def save(self, path):
        """An uncompressed .npz (np.load reads it as it reads a compressed
        one): the tables of 25 views at 65,536 columns are 0.82 GB, which
        zlib took ~90 s to write on an H100 host, inside every rematch."""
        np.savez(path, kpts=self.kpts, certainty=self.certainty)

    @classmethod
    def load(cls, path) -> "MatchTables":
        z = np.load(path)
        return cls(kpts=z["kpts"].astype(np.float32), certainty=z["certainty"].astype(np.float32))

    @classmethod
    def zeros(cls, num_views: int, num_columns: int) -> "MatchTables":
        """Empty tables (the reference starts from zeros and fills at the
        first rematch; zeros give zero certainty => zero loss)."""
        return cls(
            kpts=np.zeros((num_views, num_views, num_columns, 4), np.float32),
            certainty=np.zeros((num_views, num_views, num_columns), np.float32),
        )


def _uniform_grid_subset(total: int, n: int) -> np.ndarray:
    """n indices spread uniformly over [0, total) — a non-perfect-square
    n no longer drops the grid's trailing (bottom) rows wholesale, which
    biased correspondence coverage toward the top of the image
    (ADVICE r4 #5).  Identity when n == total."""
    if n > total:
        raise ValueError(f"n_points={n} exceeds grid size {total}")
    return np.round(np.linspace(0, total - 1, n)).astype(np.int64)


class Matcher(Protocol):
    def match(self, img0: np.ndarray, img1: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """img: [H, W, 3] float32 in [0,1].  Returns (kpts0 [P,2],
        kpts1 [P,2], certainty [P]) in pixel coordinates."""
        ...


@dataclasses.dataclass
class GridStubMatcher:
    """Identity-grid matcher for dry runs and scale tests (config
    `matcher = stub`).

    Returns a uniform pixel grid matched to the SAME coordinates in the
    other view with constant certainty.  For small-baseline forward-facing
    bursts this approximates the true correspondence (parallax of a few
    pixels), so the CTE loss becomes a mild cross-view color-consistency
    prior — enough to exercise the full consist/rematch machinery at
    scale without pretrained DKM weights.  Deterministic and
    content-independent, hence trivially identical across hosts."""

    n_points: int = 256
    certainty: float = 0.9

    def match(self, img0, img1):
        h, w = img0.shape[:2]
        g = int(np.ceil(np.sqrt(self.n_points)))
        xs = (np.arange(g) + 0.5) * w / g
        ys = (np.arange(g) + 0.5) * h / g
        gx, gy = np.meshgrid(xs, ys)
        sel = _uniform_grid_subset(g * g, self.n_points)
        k0 = np.stack([gx.ravel(), gy.ravel()], -1)[sel].astype(np.float32)
        return k0, k0.copy(), np.full(self.n_points, self.certainty, np.float32)


@dataclasses.dataclass
class GroundTruthMatcher:
    """Geometry-exact matcher for synthetic scenes with known depth.

    Emits the correspondences a perfect dense matcher would: a grid of
    pixels in view k is unprojected through the view's z-depth map,
    transformed to world, and reprojected into view v; certainty is high
    where the reprojection lands in-bounds AND the target view's depth
    agrees (i.e. the point is not occluded there), zero otherwise.  This
    feeds the CTE stage real, non-identity, variable-certainty
    correspondence structure — the semantics of the reference's frozen
    DKMv3 matches (run_lushnerf.py:745-774) — without pretrained weights.

    Construction uses the TRAINING-frame geometry: `poses` are the
    post-LLFF-load camera-to-world matrices of the matched views (in
    render order), `focal`/`H`/`W` the full-resolution intrinsics, and
    `depths` [V, H, W] z-depth maps in the SAME world units (i.e. raw
    scene depths times the loader's bd rescale factor; np.inf = sky).

    Matching is index-based (`match_idx`) — image content is ignored —
    so it is deterministic and trivially identical across hosts.
    """

    poses: np.ndarray  # [V, 3, 4]
    focal: float
    H: int
    W: int
    depths: np.ndarray  # [V, H, W]
    n_points: int = 256
    certainty: float = 0.95
    occl_rel_tol: float = 0.03  # |z_v - depth_v| <= tol * depth_v => visible

    def match_idx(self, k: int, v: int, img0, img1):
        h, w = img0.shape[:2]
        sx, sy = self.W / w, self.H / h  # rendered res -> full res

        g = int(np.ceil(np.sqrt(self.n_points)))
        # integer full-res pixel indices on a uniform grid (the CTE
        # consumer floors coords and shoots the pixel-CENTER ray,
        # train/consistency.py:rays_at_pixels — so correspondences are
        # computed for exactly those center rays)
        xs = np.clip(((np.arange(g) + 0.5) * self.W / g - 0.5).round(), 0, self.W - 1)
        ys = np.clip(((np.arange(g) + 0.5) * self.H / g - 0.5).round(), 0, self.H - 1)
        gx, gy = np.meshgrid(xs, ys)
        sel = _uniform_grid_subset(g * g, self.n_points)
        xi = gx.ravel()[sel].astype(np.int64)
        yi = gy.ravel()[sel].astype(np.int64)

        z = self.depths[k][yi, xi]  # [P]
        valid = np.isfinite(z) & (z > 0)

        # pixel-center ray in camera frame (ops/rays.get_rays convention:
        # (i + 0.5 - 0.5W)/f, y flipped, -z forward); with dir_z = -1 the
        # ray parameter equals z-depth
        f = self.focal
        dirs = np.stack(
            [
                (xi + 0.5 - 0.5 * self.W) / f,
                -(yi + 0.5 - 0.5 * self.H) / f,
                -np.ones_like(xi, np.float64),
            ],
            axis=-1,
        )
        ck, cv = self.poses[k], self.poses[v]
        zs = np.where(valid, z, 1.0)
        p_world = ck[:, 3] + (dirs @ ck[:3, :3].T) * zs[:, None]

        p_cam = (p_world - cv[:, 3]) @ cv[:3, :3]  # R^T (p - t)
        z_v = -p_cam[:, 2]
        front = z_v > 1e-6
        z_v_safe = np.where(front, z_v, 1.0)
        x_v = p_cam[:, 0] / z_v_safe * f + 0.5 * self.W - 0.5
        y_v = -p_cam[:, 1] / z_v_safe * f + 0.5 * self.H - 0.5
        inb = (x_v >= 0) & (x_v <= self.W - 1) & (y_v >= 0) & (y_v <= self.H - 1)

        ok = valid & front & inb
        # occlusion: the target view must see the same surface there
        xv_i = np.clip(np.round(x_v), 0, self.W - 1).astype(np.int64)
        yv_i = np.clip(np.round(y_v), 0, self.H - 1).astype(np.int64)
        d_v = self.depths[v][yv_i, xv_i]
        vis = np.isfinite(d_v) & (np.abs(z_v - d_v) <= self.occl_rel_tol * np.maximum(d_v, 1e-6))
        cert = np.where(ok & vis, self.certainty, 0.0).astype(np.float32)

        k0 = np.stack([xi / sx, yi / sy], -1).astype(np.float32)
        k1 = np.stack(
            [np.clip(x_v, 0, self.W - 1) / sx, np.clip(y_v, 0, self.H - 1) / sy], -1
        ).astype(np.float32)
        return k0, k1, cert

    def match(self, img0, img1):
        raise NotImplementedError(
            "GroundTruthMatcher is index-based; use match_idx(k, v, ...) "
            "(match_pairs dispatches to it automatically)"
        )


@dataclasses.dataclass
class PrecomputedMatcher:
    """Serves matches from precomputed tables (frozen-matcher semantics)."""

    tables: MatchTables
    _k: int = 0
    _v: int = 0

    def match(self, img0, img1):
        raise NotImplementedError(
            "PrecomputedMatcher serves whole tables; use .tables directly"
        )


def match_pairs(matcher: Matcher, images: np.ndarray, pairs):
    """Run the matcher over an explicit list of ordered (k, v) view pairs.

    Returns (kpts [n_pairs, P, 4], certainty [n_pairs, P]): the work unit
    of a rematch (a striped rematch would give each process a subset of
    the V*V pairs)."""
    if hasattr(matcher, "match_many"):
        # cached fast path (DKMMatcher): V encoder passes + batched
        # single-direction decoder launches instead of a full symmetric
        # pass per ordered pair
        return matcher.match_many(images, list(pairs))
    first = None
    kpts_l, cert_l = [], []
    indexed = hasattr(matcher, "match_idx")  # view-identity-aware matchers
    for (k, v) in pairs:
        if indexed:
            k0, k1, c = matcher.match_idx(k, v, images[k], images[v])
        else:
            k0, k1, c = matcher.match(images[k], images[v])
        if first is None:
            first = len(c)
        elif len(c) != first:
            # a fixed-resolution matcher (DKM) always returns the same
            # count; anything else would silently index-misalign the
            # [V, V, P] tables, so fail loudly
            raise ValueError(
                f"matcher returned {len(c)} columns for pair ({k},{v}), "
                f"expected {first} (all pairs must match in column count)"
            )
        kpts_l.append(np.concatenate([k0, k1], -1))
        cert_l.append(c)
    return (
        np.stack(kpts_l).astype(np.float32),
        np.stack(cert_l).astype(np.float32),
    )


def build_match_tables(matcher: Matcher, images: np.ndarray) -> MatchTables:
    """Run the matcher over every ordered view pair (the reference's
    rematch pass, run_lushnerf.py:747-774), in one process."""
    V = images.shape[0]
    pairs = [(k, v) for k in range(V) for v in range(V)]
    kpts, cert = match_pairs(matcher, images, pairs)
    P = kpts.shape[1]
    return MatchTables(
        kpts=kpts.reshape(V, V, P, 4),
        certainty=cert.reshape(V, V, P),
    )


def nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """img [H, W, ...] -> [h, w, ...] by cv2.resize's INTER_NEAREST: output
    pixel x reads input pixel min(floor(x * (1 / (w / W))), W - 1), the
    inverse scale formed in double as cv2 forms it (resizeNN)."""
    def idx(src: int, dst: int) -> np.ndarray:
        inv = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * inv), src - 1).astype(np.int64)

    return img[idx(img.shape[0], h)][:, idx(img.shape[1], w)]


def load_gt_depths(datadir, n: int, H: int, W: int, bd_factor: float) -> np.ndarray:
    """[n, H, W] z-depths for `matcher = gt`: datadir/depth/NNN.npy (one per
    view) in the loader's world units (raw depth times its bd rescale,
    1 / (min raw near bound * bd_factor); recentring is rigid), brought to
    H x W by nearest resize where they differ (lushnerf_tpu's trainer calls
    cv2.resize with INTER_NEAREST)."""
    from pathlib import Path

    dd = Path(datadir)
    depth_files = sorted((dd / "depth").glob("*.npy"))
    if len(depth_files) != n:
        raise FileNotFoundError(
            f"matcher=gt needs one depth/NNN.npy per view in "
            f"{dd} (found {len(depth_files)}, expected {n})"
        )
    raw_bds = np.load(dd / "poses_bounds.npy")[:, -2:]
    sc = 1.0 / (raw_bds.min() * bd_factor)
    depths = np.stack([np.load(p) for p in depth_files]).astype(np.float32) * sc
    if depths.shape[1:] != (H, W):
        depths = np.stack([nearest_resize(d, H, W) for d in depths])
    return depths
