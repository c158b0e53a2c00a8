"""The learned tone maps (lushnerf_torch/models/tonemap.py) against
lushnerf_tpu's `apply_tonemap` on the CPU: values, input and parameter
grads of all four maps on the same params (rtol 1e-5); the weight bridge
both ways and a reference `.tar` with `tonemapping.linear.*` under
strict=True; checkpoints; a `learn` config's train step against the JAX
Trainer's; `render_image` and `render_warped_view` under `split_linear`
against JAX's."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.models import lushnerf as jl
from lushnerf_tpu.models import tonemap as jtm
from lushnerf_tpu.train.torch_import import save_torch_checkpoint
from lushnerf_torch.convert import (
    load_reference_checkpoint,
    params_to_jax,
    tonemap_state_from_jax,
)
from lushnerf_torch.models import lushnerf as tl
from lushnerf_torch.models import tonemap as ttm
from lushnerf_torch.train import checkpoint as ckpt_lib
from lushnerf_torch.train import trainer
from tests.test_torch_convert import _assert_tree_equal, jax_params, params_like_init
from tests.test_torch_lushnerf import FOCAL, H, W, _draws, _model
from tests.test_torch_train import (
    _batch_both,
    _compare_grads,
    _configs,
    _grads_by_name,
    _jax_step_fns,
)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4  # tests/test_torch_train.py's limit for a whole step's grads


def _tonemap_params(map_type, seed):
    """A JAX tone-map params tree at init scales (numpy leaves)."""
    return params_like_init(lambda k: jtm.init_tonemap(k, map_type), seed)


def _module(map_type, params):
    """The port's ToneMapping holding the JAX params (through convert)."""
    if map_type not in ttm.LEARNED_TYPES:
        return None
    mod = ttm.ToneMapping(map_type, torch.Generator().manual_seed(0), torch.device("cpu"))
    mod.load_state_dict(tonemap_state_from_jax(params), strict=True)
    return mod


@pytest.mark.parametrize("map_type,eps", [("none", 0.0), ("gamma", 1e-4), ("learn", 0.0),
                                          ("split_linear", 0.0)])
def test_tonemap_values_and_grads_match_jax(map_type, eps):
    rng = np.random.default_rng(5)
    x = rng.uniform(0.01, 1.2, (2, 37, 3)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    params = _tonemap_params(map_type, seed=6) if map_type in ttm.LEARNED_TYPES else {}

    def jloss(p, xj):
        return jnp.sum(jtm.apply_tonemap(p, map_type, xj, eps) * w)

    want = jtm.apply_tonemap(params, map_type, jnp.asarray(x), eps)
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))

    mod = _module(map_type, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ttm.apply_tonemap(map_type, xt, eps, mod)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    if mod is not None:
        want_g = tonemap_state_from_jax(jax.tree.map(np.asarray, jgp))
        for name, p in mod.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                       **TOL, err_msg=name)


def test_tonemap_refuses_a_missing_or_unknown_map():
    x = torch.rand(4, 3)
    with pytest.raises(ValueError, match="needs its ToneMapping"):
        ttm.apply_tonemap("learn", x)
    with pytest.raises(ValueError, match="needs its ToneMapping"):
        ttm.apply_tonemap("split_linear", x, tonemap=_module("learn", _tonemap_params("learn", 0)))
    with pytest.raises(ValueError, match="not recognized"):
        ttm.apply_tonemap("sigmoid", x)


@pytest.mark.parametrize("map_type", ["learn", "split_linear"])
def test_tonemap_convert_round_trip_and_checkpoint(map_type, tmp_path):
    _, lc, _, jlc = _configs(tiny=True, tone_mapping_type=map_type)
    params = jax_params(jlc, seed=11)
    model = _model(lc, params)  # load_state_dict(strict=True)
    assert isinstance(model.tonemapping, ttm.ToneMapping)
    _assert_tree_equal(params_to_jax(model.state_dict()), params)
    # the port's checkpoint keeps the map and Adam's state for it
    cfg, lc2, _, _ = _configs(tiny=True, tone_mapping_type=map_type)
    opt, sched = trainer.make_optimizer(cfg, model)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    path = ckpt_lib.save_checkpoint(tmp_path, 7, model, opt, sched)
    fresh = tl.LushNeRF(lc2, seed=3, device="cpu")
    fopt, fsched = trainer.make_optimizer(cfg, fresh)
    assert ckpt_lib.load_checkpoint(path, fresh, fopt, fsched) == 7
    for (k, v), (k2, v2) in zip(model.tonemapping.state_dict().items(),
                                fresh.tonemapping.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    tm_ids = {id(p) for p in fresh.tonemapping.parameters()}
    assert sum(id(p) in tm_ids for p in fopt.param_groups[0]["params"]) == len(tm_ids)


def test_reference_tar_with_learned_tonemap_loads_strict(tmp_path):
    _, lc, _, jlc = _configs(tiny=True, tone_mapping_type="learn")
    params = jax_params(jlc, seed=12)
    save_torch_checkpoint(tmp_path / "ref.tar", 123, params)
    step, sd = load_reference_checkpoint(tmp_path / "ref.tar")
    assert step == 123 and "tonemapping.linear.6.weight" in sd
    model = tl.LushNeRF(lc, seed=0, device="cpu")
    model.load_state_dict(sd, strict=True)
    _assert_tree_equal(params_to_jax(model.state_dict())["tonemap"], params["tonemap"])


@pytest.mark.parametrize("stage", ["naive", "kernel"])
def test_train_step_learn_matches_jax(stage, monkeypatch):
    """A `learn` config's step: the loss and every grad, the tone map's
    included, against the JAX Trainer's `_loss_fn` on the same draws."""
    cfg, lc, jcfg, jlc = _configs(tiny=True, tone_mapping_type="learn")
    params = jax_params(jlc, seed=13)
    batch, jbatch = _batch_both(6, seed=14)
    n_rays = 6 if stage == "naive" else 6 * lc.rbk.num_rays_out
    rnd = _draws(lc, n_rays, seed=15)
    vg, _ = _jax_step_fns(jlc, jcfg, stage, {k: jnp.asarray(v) for k, v in rnd.items()},
                          monkeypatch)
    (jloss, _), jgrads = jax.jit(vg)(params, jbatch)
    model = _model(lc, params)
    loss, _ = trainer.loss_fn(model, lc, H, W, FOCAL, batch, stage,
                              rand_override={k: torch.from_numpy(v) for k, v in rnd.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = _grads_by_name(model)
    assert any(k.startswith("tonemapping.") and np.abs(g).max() > 0 for k, g in got.items())

    # each tensor within GRAD_REL of its max, or 1e-9 absolute (the limits
    # of tests/test_torch_train.py), or GRAD_REL of its module's largest
    # grad: an alpha head's bias grad is one sum over every point, which
    # cancels (measured: mlp_coarse.alpha_linear.bias 5.9e-6, 1.2e-9 apart)
    module_max = {}
    for name, g in got.items():
        top = name.split(".")[0]
        module_max[top] = max(module_max.get(top, 0.0), float(np.abs(g).max()))

    def check(name, g, w):
        diff = np.abs(g - w).max()
        err = diff / max(np.abs(w).max(), 1e-30)
        assert (err <= GRAD_REL or diff <= 1e-9
                or diff <= GRAD_REL * module_max[name.split(".")[0]]), (name, err)

    _compare_grads(got, jgrads, check)


def test_render_image_and_warped_view_split_linear_match_jax():
    _, lc, _, jlc = _configs(tiny=True, tone_mapping_type="split_linear")
    params = jax_params(jlc, seed=16)
    model = _model(lc, params)
    h, w = 6, 5
    K = np.array([[FOCAL, 0, 0.5 * w], [0, FOCAL, 0.5 * h], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    render = jax.jit(functools.partial(jl.render_image, cfg=jlc, H=h, W=w, ray_chunk=16))
    want = render(params, K=jnp.asarray(K), c2w=jnp.asarray(c2w))
    got = tl.render_image(model, lc, h, w, K, c2w, ray_chunk=16)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-4, atol=1e-5)
    want_w = jl.render_warped_view(params, jlc, h, w, jnp.asarray(K), jnp.asarray(c2w), 1,
                                   ray_chunk=32)
    got_w = tl.render_warped_view(model, lc, h, w, K, c2w, 1, ray_chunk=32)
    np.testing.assert_allclose(got_w[0].numpy(), np.asarray(want_w[0]), rtol=1e-4, atol=1e-5)
