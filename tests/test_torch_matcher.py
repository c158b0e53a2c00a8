"""The port's match tables and matchers (lushnerf_torch/matcher/api.py)
against lushnerf_tpu's on the CPU: `MatchTables.sample_anchor` draws the
same anchor and columns bit for bit from the same numpy `Generator`; the
`.npz` tables written by either package load in the other; the stub and
ground-truth matchers' tables equal the JAX package's bit for bit, the
ground-truth one also through each trainer's `matcher = gt` setup on an
LLFF scene on disk whose depth maps have another size than its images;
`nearest_resize` equals cv2's INTER_NEAREST; a ragged matcher raises.
"""

import numpy as np
import pytest

import cv2

from lushnerf_tpu.config import Config as JConfig
from lushnerf_tpu.matcher import api as japi
from lushnerf_tpu.train.trainer import Trainer as JTrainer
from lushnerf_torch.config import Config
from lushnerf_torch.matcher import api
from lushnerf_torch.train import trainer as tt
from tests.test_torch_data import write_llff_scene
from tests.test_torch_trainer import tiny_kwargs


@pytest.fixture(autouse=True)
def _restore_jax_kernel_mesh():
    """lushnerf_tpu's Trainer registers its 8-device CPU mesh for the fused
    Pallas kernels process-wide (`set_kernel_mesh`); left set, a later
    interpret-mode kernel test in the same worker shards over it and hangs.
    Each test here gives the previous mesh back."""
    from lushnerf_tpu.parallel.mesh import get_kernel_mesh, set_kernel_mesh

    mesh = get_kernel_mesh()
    yield
    set_kernel_mesh(mesh)


def _tables(pkg, V=4, P=50, seed=0):
    rng = np.random.default_rng(seed)
    return pkg.MatchTables(kpts=rng.uniform(0, 40, (V, V, P, 4)).astype(np.float32),
                           certainty=rng.random((V, V, P), dtype=np.float32))


def _assert_tables_equal(a, b):
    for k in ("kpts", "certainty"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_sample_anchor_bitwise():
    ours, theirs = _tables(api), _tables(japi)
    r1, r2 = np.random.default_rng([3, 7919]), np.random.default_rng([3, 7919])
    for n_pix in (32, 32, 5, 1):
        a, pix, cert = ours.sample_anchor(r1, n_pix)
        b, jpix, jcert = theirs.sample_anchor(r2, n_pix)
        assert a == b
        assert pix.shape == (4, n_pix, 2) and cert.shape == (4, n_pix)
        np.testing.assert_array_equal(pix, jpix)
        np.testing.assert_array_equal(cert, jcert)
    assert r1.integers(1 << 30) == r2.integers(1 << 30)  # the streams stay in step


def test_npz_tables_load_in_either_package(tmp_path):
    ours, theirs = _tables(api, seed=1), _tables(japi, seed=1)
    ours.save(tmp_path / "port.npz")
    theirs.save(tmp_path / "jax.npz")
    _assert_tables_equal(japi.MatchTables.load(tmp_path / "port.npz"), ours)
    _assert_tables_equal(api.MatchTables.load(tmp_path / "jax.npz"), theirs)
    _assert_tables_equal(api.MatchTables.zeros(3, 17), japi.MatchTables.zeros(3, 17))


def test_stub_tables_match_jax():
    images = np.random.default_rng(2).random((3, 24, 40, 3), dtype=np.float32)
    for n_points in (256, 50):  # a square grid and one cut to n_points
        got = api.build_match_tables(api.GridStubMatcher(n_points=n_points), images)
        want = japi.build_match_tables(japi.GridStubMatcher(n_points=n_points), images)
        assert got.kpts.shape == (3, 3, n_points, 4)
        _assert_tables_equal(got, want)
        assert (got.certainty == np.float32(0.9)).all()


def _gt_inputs(seed=4, V=4, H=20, W=28):
    """Forward-facing poses a little apart and smooth depths with sky."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (V, 1, 1))
    poses[:, :, 3] = rng.uniform(-0.15, 0.15, (V, 3))
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    depths = np.stack([2.0 + 0.5 * np.sin(3 * xx + i) * np.cos(2 * yy) for i in range(V)])
    depths[:, :2, :3] = np.inf
    return poses, depths.astype(np.float32), H, W


def test_gt_tables_match_jax():
    poses, depths, H, W = _gt_inputs()
    images = np.zeros((len(poses), H // 2, W // 2, 3), np.float32)  # matched at half res
    kw = dict(poses=poses, focal=0.9 * W, H=H, W=W, depths=depths, n_points=100)
    got = api.build_match_tables(api.GroundTruthMatcher(**kw), images)
    want = japi.build_match_tables(japi.GroundTruthMatcher(**kw), images)
    _assert_tables_equal(got, want)
    assert 0 < (got.certainty > 0).mean() < 1  # confident and occluded or out-of-view columns


@pytest.mark.parametrize("src,dst", [((20, 28), (20, 28)), ((11, 13), (20, 28)),
                                     ((40, 56), (20, 28)), ((17, 29), (24, 21)),
                                     ((378, 504), (756, 1008)), ((7, 3), (50, 1))])
def test_nearest_resize_matches_cv2(src, dst):
    img = np.random.default_rng(5).random(src, dtype=np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    got = api.nearest_resize(img, *dst)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_gt_setup_matches_jax_trainer(tmp_path):
    """`matcher = gt` on an LLFF scene on disk with depth/NNN.npy at 11 x 13
    (the images 16 x 16): the depths (bd-scaled, nearest-resized) and the
    train poses each trainer hands its GroundTruthMatcher, and its tables
    on renders at the eval resolution."""
    scene = write_llff_scene(tmp_path / "scene", n=4, H=16, W=16)
    (scene / "depth").mkdir()
    rng = np.random.default_rng(6)
    for i in range(4):
        np.save(scene / "depth" / f"{i:03d}.npy", rng.uniform(1.5, 6.0, (11, 13)))
    kw = tiny_kwargs(tmp_path, datadir=str(scene), matcher="gt", llffhold=4)
    ours = tt.Trainer(Config(**dict(kw, basedir=str(tmp_path / "port"))), device="cpu")
    ours.setup()
    theirs = JTrainer(JConfig(**dict(kw, basedir=str(tmp_path / "jax"))))
    theirs.setup()
    m, jm = ours._matcher, theirs._matcher
    assert isinstance(m, api.GroundTruthMatcher) and m.n_points == jm.n_points == 1024
    assert (m.focal, m.H, m.W) == (jm.focal, jm.H, jm.W)
    np.testing.assert_array_equal(m.poses, jm.poses)
    assert m.depths.shape == jm.depths.shape == (3, 16, 16)
    np.testing.assert_array_equal(m.depths, jm.depths)
    images = np.zeros((3, 8, 8, 3), np.float32)
    _assert_tables_equal(api.build_match_tables(m, images), japi.build_match_tables(jm, images))


def test_ragged_matcher_raises():
    class RaggedMatcher:
        def __init__(self):
            self.n = iter([10, 10, 10, 7])

        def match(self, a, b):
            n = next(self.n)
            z = np.zeros((n, 2), np.float32)
            return z, z, np.ones(n, np.float32)

    with pytest.raises(ValueError, match="7 columns for pair \\(1,1\\), expected 10"):
        api.build_match_tables(RaggedMatcher(), np.zeros((2, 8, 8, 3), np.float32))
