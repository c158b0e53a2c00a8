"""lushnerf_torch/utils/extra_losses.py and models/mam.py against
lushnerf_tpu's on the CPU: each function's value and its input grads on
the same random inputs (MAM's parameter grads too), f32, at the stated
tolerances: rtol 1e-5 where the two compute the same sums; MS-SSIM's
17x17 Gaussian bank sums in another order (conv2d against XLA's), its
loss and grads within rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.models import mam as jmam
from lushnerf_tpu.utils import extra_losses as jx
from lushnerf_torch.models import mam as tmam
from lushnerf_torch.utils import extra_losses as tx
from tests.test_torch_convert import params_like_init

TOL = dict(rtol=1e-5, atol=1e-6)
MS_SSIM_TOL = dict(rtol=1e-4, atol=1e-6)


def _grads_match(jfn, tfn, args, tol):
    """Value and grads w.r.t. every argument of jfn (JAX, jitted) and tfn
    (torch) on the same numpy args; the output is reduced against fixed
    random weights so that every element's grad is held."""
    jout = jfn(*[jnp.asarray(a) for a in args])
    w = np.random.default_rng(99).standard_normal(np.shape(jout)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(args)))))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **tol)
    for ta, g in zip(targs, jg):
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(g), **tol)


def test_correlation_coefficient_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 4)).astype(np.float32)
    y = (0.5 * x + rng.standard_normal((50, 4))).astype(np.float32)
    _grads_match(jx.compute_correlation_coefficient, tx.compute_correlation_coefficient,
                 (x, y), TOL)


@pytest.mark.parametrize("std", [0.1, 0.5])
def test_kde_matches_jax(std):
    x = np.random.default_rng(1).uniform(-1, 1, (40, 3)).astype(np.float32)
    _grads_match(lambda a: jx.kde(a, std), lambda a: tx.kde(a, std), (x,), TOL)


@pytest.mark.parametrize("map_type", ["none", "white_balance", "white_balance_consistent"])
def test_white_balance_matches_jax(map_type):
    rng = np.random.default_rng(2)
    x = rng.random((8, 3), dtype=np.float32)
    idx = rng.integers(0, 5, 8)
    jp = jx.white_balance_init(map_type, 5)
    tp = tx.white_balance_init(map_type, 5, device="cpu")
    assert {k: v.shape for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    gains = {k: rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in gains.items()}
    want = jx.white_balance_apply({k: jnp.asarray(v) for k, v in gains.items()}, map_type,
                                  jnp.asarray(x), jnp.asarray(idx))
    got = tx.white_balance_apply(tp, map_type, torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if gains:
        got.sum().backward()
        jg = jax.grad(lambda p: jnp.sum(jx.white_balance_apply(p, map_type, jnp.asarray(x),
                                                               jnp.asarray(idx))))(
            {k: jnp.asarray(v) for k, v in gains.items()})
        np.testing.assert_allclose(tp["wb"].grad.numpy(), np.asarray(jg["wb"]), **TOL)
    with pytest.raises(ValueError):
        tx.white_balance_init("grey_world", 5, device="cpu")


def test_ms_ssim_l1_loss_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 20, 23), dtype=np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    _grads_match(jax.jit(jx.ms_ssim_l1_loss), tx.ms_ssim_l1_loss, (x, y), MS_SSIM_TOL)


def test_mam_matches_jax():
    """apply_mam: the output and the grads of both inputs and of every
    parameter; the BatchNorm takes the batch's statistics."""
    C, M, n_ray, L = 32, 4, 6, 7
    params = params_like_init(lambda k: {kk: v for kk, v in jmam.init_mam(k, C, M).items()
                                         if kk != "num_motion"}, seed=4)
    rng = np.random.default_rng(5)
    params["convd_bn"] = tuple(rng.uniform(0.5, 1.5, C).astype(np.float32) for _ in range(2))
    params["num_motion"] = M
    xg = rng.standard_normal((n_ray, M + 1, C)).astype(np.float32)
    xl = rng.standard_normal((n_ray * (M + 1), L, tmam.LOCAL_CH)).astype(np.float32)
    mod = tmam.mam_from_jax(params, device="cpu")
    jparams = {k: v for k, v in params.items() if k != "num_motion"}

    def jfn(p, a, b):
        return jmam.apply_mam(dict(p, num_motion=M), a, b)

    jout = jax.jit(jfn)(jparams, xg, xl)
    w = rng.standard_normal(np.shape(jout)).astype(np.float32)
    jgp, jga, jgb = jax.jit(jax.grad(lambda p, a, b: jnp.sum(jfn(p, a, b) * w),
                                     argnums=(0, 1, 2)))(jparams, xg, xl)
    a, b = (torch.from_numpy(v).requires_grad_(True) for v in (xg, xl))
    out = tmam.apply_mam(mod, a, b)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jga), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jgb), **TOL)
    # each parameter's grad, a sum over every ray and motion sample, within
    # rtol of its tensor's largest value, or of the module's largest grad:
    # `linear.bias`'s is 0 in exact arithmetic (a shift of every local
    # feature moves each softmax's logits by a constant, and the BatchNorm
    # takes the rest), ~2e-5 of rounding against the others' ~10-80
    want = tmam.mam_from_jax(dict(jax.tree.map(np.asarray, jgp), num_motion=M),
                             device="cpu").state_dict()
    scale = max(float(v.abs().max()) for v in want.values())
    for name, p in mod.named_parameters():
        diff = np.abs(p.grad.numpy() - want[name].numpy()).max()
        assert diff <= TOL["rtol"] * max(np.abs(want[name].numpy()).max(),
                                         scale * (name == "linear.bias")), (name, diff)
