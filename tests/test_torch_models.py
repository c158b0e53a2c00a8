"""lushnerf_torch.models against lushnerf_tpu.models on the same params
(through lushnerf_torch.convert) and the same numpy inputs, at small widths.
f32 throughout: outputs agree to rtol 1e-5 / atol 1e-5 (sums taken in
another order), renders to 1e-4 (those sums then feed the importance
sampler)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.models import mlp as jmlp
from lushnerf_tpu.models import rbk as jrbk
from lushnerf_tpu.models import renderer as jren
from lushnerf_tpu.models import tonemap as jtm
from lushnerf_torch.convert import mlp_state_from_jax, params_from_jax
from lushnerf_torch.models import mlp as tmlp
from lushnerf_torch.models import renderer as tren
from lushnerf_torch.models import tonemap as ttm
from lushnerf_torch.models.lushnerf import LushConfig, LushNeRF
from lushnerf_torch.models.rbk import RBKConfig, apply_rbk, rbk_weighted_sum
from tests.test_torch_convert import jax_params, params_like_init

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _port_mlp(cfg_kwargs, params):
    m = tmlp.NeRFMLP(tmlp.MLPConfig(**cfg_kwargs), torch.Generator().manual_seed(0), CPU)
    m.load_state_dict(mlp_state_from_jax(params), strict=True)
    return m


@pytest.mark.parametrize(
    "kw",
    [dict(depth=8, width=64, input_ch=63, input_ch_views=27),
     dict(depth=4, width=32, input_ch=63, input_ch_views=27, rgb_only=True)],
    ids=["scene-skip4", "noise-d4-skip-never-fires"],
)
def test_nerf_mlp(kw):
    jcfg = jmlp.MLPConfig(**kw)
    params = params_like_init(lambda k: jmlp.init_nerf_mlp(k, jcfg), seed=1)
    m = _port_mlp(kw, params)
    if kw["depth"] == 4:
        assert all(lin.in_features != 32 + 63 for lin in m.pts_linears)
    rng = np.random.default_rng(0)
    x_pe = rng.standard_normal((50, 63)).astype(np.float32)
    d_pe = rng.standard_normal((50, 27)).astype(np.float32)
    want = jmlp.apply_nerf_mlp(params, jcfg, jnp.asarray(x_pe), jnp.asarray(d_pe))
    _close(m(_t(x_pe), _t(d_pe)), want)


def test_rbk_with_guards():
    cfg = RBKConfig(num_images=3, num_motion=4, embed_ch=16, width=32, r_width=8,
                    v_width=8, w_width=8, rv_window=0.5, zero_head_bias=True,
                    center_bundle=True, guard_dz=True)
    jcfg = jrbk.RBKConfig(**dataclasses.asdict(cfg))
    lush = LushConfig(rbk=cfg, num_images=3, netwidth=16, netwidth_fine=16,
                      render=tren.RenderConfig(multires=2, multires_views=1))
    params = jax_params(_jax_lush(lush), seed=2)
    model = LushNeRF(lush, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    rng = np.random.default_rng(3)
    rays = rng.standard_normal((20, 3, 2)).astype(np.float32)
    rays[:, 2, 1] = -np.abs(rays[:, 2, 1]) - 0.2
    rays[:3, 2, 1] = 0.01  # dz >= -eps on the original ray: the guard fires
    idx = rng.integers(0, 3, 20)
    j_sub, j_ccw = jrbk.apply_rbk(params["rbk"], jcfg, jnp.asarray(rays), jnp.asarray(idx))
    t_sub, t_ccw = apply_rbk(model.mlp_rbk, _t(rays), _t(idx))
    _close(t_ccw, j_ccw)
    _close(t_sub, j_sub)
    # dz = +0.01: the guard replaced slots of rays 0..2 by the original ray
    assert (t_sub[:3] == _t(rays[:3])[:, None]).all(-1).all(-1).any()
    _close(rbk_weighted_sum(t_sub, t_ccw), jrbk.rbk_weighted_sum(j_sub, j_ccw))


@pytest.mark.parametrize("map_type,eps", [("none", 0.0), ("gamma", 0.0), ("gamma", 1e-4)])
def test_tonemap(map_type, eps):
    x = np.random.default_rng(4).uniform(-0.1, 1.2, (64, 3)).astype(np.float32)
    x[0] = 0.0
    want = jtm.apply_tonemap({}, map_type, jnp.asarray(x), eps)
    _close(ttm.apply_tonemap(map_type, _t(x), eps), want, rtol=1e-6, atol=1e-6, equal_nan=True)


def _jax_lush(lc):
    """The JAX LushConfig with the same fields ('torch' backend = 'xla')."""
    from lushnerf_tpu.models.lushnerf import LushConfig as JLushConfig

    r = dataclasses.asdict(lc.render)
    r["mlp_backend"] = {"torch": "xla", "cuda": "pallas"}[r["mlp_backend"]]
    fields = {f.name: getattr(lc, f.name) for f in dataclasses.fields(lc)}
    fields.update(render=jren.RenderConfig(**r), rbk=jrbk.RBKConfig(**dataclasses.asdict(lc.rbk)))
    return JLushConfig(**fields)


def _prepared(cfg, rays, H=16, W=16, focal=12.0):
    return dict(
        j=jren.prepare_rays(_jax_lush(LushConfig(render=cfg)).render, H, W, focal,
                            jnp.asarray(rays[..., 0]), jnp.asarray(rays[..., 1]), 0.0, 1.0),
        t=tren.prepare_rays(cfg, H, W, focal, _t(rays[..., 0]), _t(rays[..., 1]), 0.0, 1.0),
    )


@pytest.mark.parametrize("mode", ["train", "inference"])
def test_render_rays_scene_and_noise(mode):
    cfg = tren.RenderConfig(n_samples=24, n_importance=12, multires=4, multires_views=2,
                            perturb=mode == "train", rm_nearplane=40.0)
    lc = LushConfig(render=cfg, netdepth=8, netwidth=32, netdepth_fine=8, netwidth_fine=32,
                    rbk=RBKConfig(num_images=1), num_images=1)
    jlc = _jax_lush(lc)
    params = jax_params(jlc, seed=5)
    model = LushNeRF(lc, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    rng = np.random.default_rng(6)
    R = 7
    rays = rng.standard_normal((R, 3, 2)).astype(np.float32)
    rays[:, :, 0] *= 0.1
    rays[:, 2, 1] = -np.abs(rays[:, 2, 1]) - 0.5
    prep = _prepared(cfg, rays)
    for k in ("rays_o", "rays_d", "viewdirs", "near", "far"):
        _close(prep["t"][k], prep["j"][k])
    rnd = {}
    if mode == "train":
        rnd = dict(
            t_rand=rng.random((R, 24), dtype=np.float32),
            u_importance=rng.random((R, 12), dtype=np.float32),
            density_noise_coarse=rng.standard_normal((R, 23)).astype(np.float32),
            density_noise_fine=rng.standard_normal((R, 35)).astype(np.float32),
        )
    inference = mode == "inference"
    # one jitted graph: far fewer XLA compiles than op-by-op dispatch
    render = jax.jit(functools.partial(jren.render_rays_scene, mlp_cfg=jlc.mlp_cfg,
                                       cfg=jlc.render, inference=inference))
    want = render(params["coarse"], params["fine"], prepared=prep["j"],
                  **{k: jnp.asarray(v) for k, v in rnd.items()})
    got = tren.render_rays_scene(model.mlp_coarse, model.mlp_fine, lc.mlp_cfg, cfg, prep["t"],
                                 inference=inference, **{k: _t(v) for k, v in rnd.items()})
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-4, atol=1e-4)
    want_n = jren.render_rays_noise(params["noise"], jlc.noise_cfg, jlc.render, prep["j"])
    got_n = tren.render_rays_noise(model.mlp_noise_coarse, lc.noise_cfg, cfg, prep["t"])
    _close(got_n, want_n)
