"""lushnerf_torch.ops against lushnerf_tpu.ops on the same numpy inputs.

sample_pdf and merge_z_vals agree bit for bit in f32 (the JAX versions are
gather-free rewrites documented as equal to searchsorted(right) and a
stable sort) wherever the pdf and cdf sums are exact; the other ops within
1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lushnerf_tpu.ops import compositing as jcomp
from lushnerf_tpu.ops import encoding as jenc
from lushnerf_tpu.ops import rays as jrays
from lushnerf_tpu.ops import sampling as jsamp
from lushnerf_tpu.ops import se3 as jse3
from lushnerf_torch.ops import compositing as tcomp
from lushnerf_torch.ops import encoding as tenc
from lushnerf_torch.ops import rays as trays
from lushnerf_torch.ops import sampling as tsamp
from lushnerf_torch.ops import se3 as tse3

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("multires", [10, 4, 0])
def test_posenc(multires):
    rng = np.random.default_rng(0)
    # NDC coordinates lie in [-1, 1]; 2^9 * x reaches ~500
    x = rng.uniform(-1.0, 1.0, (37, 3)).astype(np.float32)
    want = jenc.posenc(jnp.asarray(x), jenc.PositionalEncoding(num_freqs=multires))
    got = tenc.posenc(_t(x), multires)
    assert got.shape[-1] == 3 + 6 * multires
    # sin/cos of arguments up to 512 differ by an ulp of the argument
    # between libms: ~3e-5 absolute
    _close(got, want, rtol=0, atol=1e-4 if multires == 10 else 1e-6)


def test_get_rays_and_ndc():
    K = np.array([[30.0, 0, 16.5], [0, 31.0, 12.0], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(1)
    c2w = np.concatenate(
        [np.linalg.qr(rng.standard_normal((3, 3)))[0], rng.standard_normal((3, 1))], 1
    ).astype(np.float32)
    jo, jd = jrays.get_rays(24, 33, jnp.asarray(K), jnp.asarray(c2w))
    to, td = trays.get_rays(24, 33, _t(K), _t(c2w))
    _close(to, jo)
    _close(td, jd)

    o = (0.1 * rng.standard_normal((50, 3))).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    jo, jd = jrays.ndc_rays(24, 33, 30.0, 1.0, jnp.asarray(o), jnp.asarray(d))
    to, td = trays.ndc_rays(24, 33, 30.0, 1.0, _t(o), _t(d))
    _close(to, jo, rtol=1e-6, atol=1e-5)
    _close(td, jd, rtol=1e-6, atol=1e-5)


def test_se3_warp():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((40, 4, 3)).astype(np.float32)
    rot = (0.1 * rng.standard_normal((40, 4, 3))).astype(np.float32)
    rot[0, 0] = 0.0  # theta = eps: the reference's eps-before-normalise path
    trans = (0.1 * rng.standard_normal((40, 4, 3))).astype(np.float32)
    want = jse3.se3_warp(jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(trans))
    got = tse3.se3_warp(_t(pts), _t(rot), _t(trans))
    _close(got, want)


@pytest.mark.parametrize("lindisp", [False, True])
def test_linear_and_stratified_z(lindisp):
    rng = np.random.default_rng(3)
    near = rng.uniform(0.1, 0.5, (9,)).astype(np.float32)
    far = rng.uniform(2.0, 4.0, (9,)).astype(np.float32)
    jz = jsamp.linear_z_vals(jnp.asarray(near), jnp.asarray(far), 64, lindisp)
    tz = tsamp.linear_z_vals(_t(near), _t(far), 64, lindisp)
    _close(tz, jz)
    t_rand = rng.random((9, 64), dtype=np.float32)
    _close(tsamp.stratify_z_vals(tz, _t(t_rand)), jsamp.stratify_z_vals(jz, jnp.asarray(t_rand)))
    _close(tsamp.det_u((9,), 64), jsamp.det_u((9,), 64), rtol=0, atol=0)


def _pow2_weights(rng, R, n):
    """Integer weights >= 256 (so the +1e-5 floor rounds away) whose row sums
    are powers of two: pdf and cdf are then exact in f32 under ANY summation
    order.  XLA's CPU reduce and jax's associative-scan cumsum associate
    differently from torch.sum / torch.cumsum, so only such inputs can pin
    the search-and-interpolate stage bit for bit."""
    w = rng.integers(256, 700, (R, n)).astype(np.float64)
    s = w[:, :-1].sum(-1)
    target = 2.0 ** np.ceil(np.log2(s + 256))
    w[:, -1] = target - s
    return w.astype(np.float32)


@pytest.mark.parametrize("det", [True, False], ids=["det", "random"])
def test_sample_pdf_exact(det):
    rng = np.random.default_rng(4)
    R, M, N = 33, 64, 64
    z = np.sort(rng.uniform(0.0, 1.0, (R, M)).astype(np.float32), axis=-1)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    weights = _pow2_weights(rng, R, M - 2)
    if det:
        u = np.ascontiguousarray(np.asarray(jsamp.det_u((R,), N)))
    else:
        u = rng.random((R, N), dtype=np.float32)
        # u exactly on cdf values: searchsorted must take the right side
        cdf = np.cumsum(weights / weights.sum(-1, keepdims=True), -1)
        u[:, :8] = cdf[:, 3:11]
    want = np.asarray(jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), jnp.asarray(u)))
    got = tsamp.sample_pdf(_t(bins), _t(weights), _t(u)).numpy()
    np.testing.assert_array_equal(got, want)

    want_m = np.asarray(jsamp.merge_z_vals(jnp.asarray(z), jnp.asarray(want)))
    got_m = tsamp.merge_z_vals(_t(z), _t(got)).numpy()
    np.testing.assert_array_equal(got_m, want_m)


def test_sample_pdf_general_weights():
    """Renderer-like weights, incl. an all-zero row (the +1e-5 floor) and a
    zero tail (denominators snap to 1): equal up to the reduction order of
    the pdf normalisation and cdf (a few f32 ulps of z)."""
    rng = np.random.default_rng(6)
    R, M, N = 33, 64, 64
    z = np.sort(rng.uniform(0.0, 1.0, (R, M)).astype(np.float32), axis=-1)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    weights = rng.random((R, M - 2), dtype=np.float32) ** 3
    weights[0] = 0.0
    weights[1, 10:] = 0.0
    u = rng.random((R, N), dtype=np.float32)
    want = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), jnp.asarray(u))
    _close(tsamp.sample_pdf(_t(bins), _t(weights), _t(u)), want, rtol=0, atol=5e-6)


def test_merge_z_vals_ties_exact():
    a = np.array([[0.1, 0.2, 0.2, 0.5]], np.float32)
    b = np.array([[0.2, 0.05, 0.5]], np.float32)
    want = np.asarray(jsamp.merge_z_vals(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tsamp.merge_z_vals(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("noise,rm", [(False, 0.0), (True, 0.0), (False, 80.0)])
def test_raw2outputs(noise, rm):
    rng = np.random.default_rng(5)
    R, N = 17, 24
    raw = rng.standard_normal((R, N, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.0, 1.0, (R, N)).astype(np.float32), axis=-1)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    dn = rng.standard_normal((R, N - 1)).astype(np.float32) if noise else None
    want = jcomp.raw2outputs(
        jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), jnp.tanh,
        lambda v: jnp.maximum(v, 0.0), None if dn is None else jnp.asarray(dn), rm,
    )
    got = tcomp.raw2outputs(
        _t(raw), _t(z), _t(d), torch.tanh, torch.relu, None if dn is None else _t(dn), rm,
    )
    for g, w in zip(got, want):
        _close(g, w)
