"""The benchmark's plain DKMv3 reference (perfbench/reference/dkm.py) on the
CPU at `TINY_DIMS`, on seeded random weights at 64 x 96:
  * against the port's rematch path, `DKMMatcher.match_many`, for the
    query direction of ordered pairs (a view with itself among them), in
    the pixels the match tables hold;
  * against lushnerf_tpu's `dkm_match`, the symmetric match the port is
    held to, which ties the reference to the same published description.
The reference takes the weights as a dict under the checkpoint's names and
imports nothing of either package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.matcher.dkm.matcher import dkm_match as jdkm_match
from lushnerf_torch.matcher.dkm import DKM, TINY_DIMS, DKMMatcher, random_state_dict
from lushnerf_torch.matcher.dkm import convert
from perfbench.reference import dkm as ref_dkm

HS, WS = 64, 96
IMG_H, IMG_W = 48, 64
# both sides run float32 on the CPU; they differ in the order of their
# operations (the GP's inverse against the port's solve, BatchNorm folded
# or not, the correlation's 1 / sqrt(c) before or after its sum).  Seen:
# keypoints within 2e-5 px, certainties within 2e-7; the limits leave 50x
# room and stay far under a pixel's rounding of the tables' use (floor)
KPT_ATOL_PX = 1e-3
CERT_ATOL = 1e-5
# tests/test_dkm.py's and tests/test_torch_dkm.py's limit against the JAX
# package (its resize matrices and gathers round differently)
JAX_TOL = 2e-4


@pytest.fixture(scope="module")
def weights():
    sd = random_state_dict(TINY_DIMS, seed=3)
    return sd, DKM.from_state_dict(sd).eval()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(11).random((3, IMG_H, IMG_W, 3), dtype=np.float32)


def _chw(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))


def _query_rows(warp, cert, max_columns):
    """The reference's query half at the port's columns, in the images'
    pixels (W (m + 1) / 2, H (m + 1) / 2)."""
    q = warp[:, :WS].reshape(-1, 4)
    c = cert[:, :WS].reshape(-1)
    idx = torch.from_numpy(np.linspace(0, HS * WS - 1, max_columns).astype(int))
    q, c = q[idx], c[idx]
    px = torch.stack([IMG_W * (q[:, 0] + 1) / 2, IMG_H * (q[:, 1] + 1) / 2,
                      IMG_W * (q[:, 2] + 1) / 2, IMG_H * (q[:, 3] + 1) / 2], dim=-1)
    return px.numpy(), c.numpy()


@pytest.mark.parametrize("pair_batch", [1, 2, 3])
def test_reference_matches_the_ports_match_many(weights, images, pair_batch):
    """The rematch's rows (one encoder pass a view, single-direction decoder
    batches) against the reference's symmetric match of each pair, one pair
    at a time."""
    sd, model = weights
    m = DKMMatcher(model, hs=HS, ws=WS, max_columns=2048, pair_batch=pair_batch)
    pairs = [(0, 1), (2, 0), (1, 1), (1, 2)]
    kpts, cert = m.match_many(images, pairs)
    assert 0.0 < float(cert.mean()) < 1.0
    for pi, (k, v) in enumerate(pairs):
        warp, c = ref_dkm.match(sd, _chw(images[k]), _chw(images[v]), HS, WS)
        ref_kpts, ref_cert = _query_rows(warp, c, 2048)
        np.testing.assert_allclose(kpts[pi], ref_kpts, rtol=0, atol=KPT_ATOL_PX)
        np.testing.assert_allclose(cert[pi], ref_cert, rtol=0, atol=CERT_ATOL)
        assert ((cert[pi] == 0) == (ref_cert == 0)).all()


def test_reference_matches_jax_dkm_match(weights, images):
    """The whole symmetric match, warp [hs, 2 ws, 4] and certainty [hs,
    2 ws], against lushnerf_tpu's on the same weights."""
    sd, model = weights
    params = {k: jnp.asarray(v) for k, v in convert.params_from_module(model).items()}
    im0, im1 = (_chw(images[i]) for i in (0, 2))
    want_warp, want_cert = jax.device_get(jax.jit(jdkm_match, static_argnums=(3, 4))(
        params, jnp.asarray(im0.numpy()), jnp.asarray(im1.numpy()), HS, WS))
    warp, cert = ref_dkm.match(sd, im0, im1, HS, WS)
    assert warp.shape == (HS, 2 * WS, 4) and cert.shape == (HS, 2 * WS)
    np.testing.assert_allclose(warp.numpy(), want_warp, rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(cert.numpy(), want_cert, rtol=JAX_TOL, atol=JAX_TOL)


def test_reference_restores_tf32_flags(weights, images):
    """The reference turns TF32 off for its own products and leaves the
    process's settings as it found them."""
    sd, _ = weights
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        seen = []
        real = ref_dkm.resnet50

        def spy(p, x):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return real(p, x)

        ref_dkm.resnet50 = spy
        try:
            ref_dkm.match(sd, _chw(images[0]), _chw(images[1]), HS, WS)
        finally:
            ref_dkm.resnet50 = real
        assert seen == [(False, False)] * 2  # both passes' encoders
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == \
            (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
