"""The port's train step (lushnerf_torch/train/) against lushnerf_tpu's on
the CPU: losses, schedule, forward_naive, Adam with the decay schedule and
the global-norm clip against optax, and whole steps of the tiny flagship
config (every grad, and the params after 3 Adam steps) with the optional
loss terms on, in each stage; then one step's grads at width 256 through
the 'cuda' bf16 path (plain versions on the CPU) against JAX's Pallas
kernel in interpret mode.

JAX's step is the Trainer's own `_loss_fn` (lushnerf_tpu/train/trainer.py)
with its forwards fed the same numpy draws as the port's.

Tolerances: f32 grads 1e-4 of each tensor's max magnitude (sums in another
order, through the importance sampler); params after 3 Adam steps 2e-6
absolute (Adam's first updates are ~lrate * sign(g), so the grads' small
differences move the params by far less than lrate = 5e-4).  bf16 at width
256: as tests/test_torch_fused_mlp_bwd.py, the two packages' PE sines
differ by ~6e-7, which flips a few bf16 roundings, and on 2 rays a flip also
moves the importance samples; each tensor within 5e-2 of its max magnitude,
and the median over tensors of mean error / mean magnitude within 1e-2
(measured 4.7e-3; the port in f32 misses it at 1.9e-2, and agrees with
JAX's f32 'xla' backend at 2.8e-5).
"""

import functools
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as ge
from lushnerf_tpu.models import lushnerf as jl
from lushnerf_tpu.train import losses as jlosses
from lushnerf_tpu.train import schedule as jschedule
from lushnerf_tpu.train import trainer as jtrainer
from lushnerf_torch.config import flagship_cfg
from lushnerf_torch.convert import params_from_jax, params_to_jax
from lushnerf_torch.models import lushnerf as tl
from lushnerf_torch.ops.fused import nerf_mlp as fused
from lushnerf_torch.train import losses, schedule, trainer
from tests.test_torch_convert import jax_params
from tests.test_torch_lushnerf import FOCAL, H, NUM_IMG, W, _batch, _draws, _model
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

GRAD_REL = 1e-4
PARAM_ATOL = 2e-6
BF16_MAX_REL = 5e-2
BF16_MEDIAN_MEAN_REL = 1e-2
OPTIONAL_TERMS = dict(rbk_anchor_reg=0.5, rbk_spread_l1=0.1, snd_l1=0.2)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a, b, t = (rng.random((7, 3), dtype=np.float32) for _ in range(3))
    got = losses.photometric_loss(*map(torch.from_numpy, (a, b, t)))
    want = jlosses.photometric_loss(*map(jnp.asarray, (a, b, t)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    mse = np.float32(0.013)
    np.testing.assert_allclose(losses.mse2psnr(torch.tensor(mse)).numpy(),
                               np.asarray(jlosses.mse2psnr(jnp.asarray(mse))), rtol=1e-6)
    rgb = rng.random((4, 9, 3), dtype=np.float32)
    conf = rng.random((4, 9), dtype=np.float32)
    conf[:, 0] = 0.0  # a pixel no view is confident about
    for thr in (0.5, 0.8):
        gm, gmask = losses.masked_consistency_mean(torch.from_numpy(rgb), torch.from_numpy(conf), thr)
        wm, wmask = jlosses.masked_consistency_mean(jnp.asarray(rgb), jnp.asarray(conf), thr)
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        np.testing.assert_allclose(
            losses.consistency_loss(torch.from_numpy(rgb), torch.from_numpy(conf), thr).numpy(),
            np.asarray(jlosses.consistency_loss(jnp.asarray(rgb), jnp.asarray(conf), thr)), rtol=1e-6)
    assert losses.CONSIST_WEIGHT == jlosses.CONSIST_WEIGHT


def test_schedule_matches_jax():
    for i in range(0, 60, 3):
        for ks, aks in ((10, 30), (0, 0), (20, 20)):
            for blur in ("dpnerf", "none"):
                assert schedule.stage_for_iter(i, ks, aks, blur) == jschedule.stage_for_iter(i, ks, aks, blur)
        assert schedule.consist_active(i, 30) == jschedule.consist_active(i, 30)
        assert schedule.consist_in_loss(i, 30) == jschedule.consist_in_loss(i, 30)
        assert schedule.lr_at(i * 1000, 5e-4, 250) == jschedule.lr_at(i * 1000, 5e-4, 250)


def test_forward_naive_tiny_flagship():
    lc = flagship_cfg(NUM_IMG, tiny=True).lush_config()
    jlc = ge._flagship_cfg(NUM_IMG, tiny=True).lush_config()
    params = jax_params(jlc, seed=21)
    rays, _, _ = _batch(6, seed=22)
    rnd = _draws(lc, 6, seed=23)
    fwd = jax.jit(functools.partial(jl.forward_naive, cfg=jlc, H=H, W=W, focal=FOCAL, key=None))
    want = fwd(params, rays=jnp.asarray(rays), rand_override={k: jnp.asarray(v) for k, v in rnd.items()})
    got = tl.forward_naive(_model(lc, params), lc, H, W, FOCAL, torch.from_numpy(rays),
                           rand_override={k: torch.from_numpy(v) for k, v in rnd.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("clip", [0.0, 10.0, 0.05], ids=["no-clip", "clip-idle", "clip-active"])
def test_adam_schedule_and_clip_match_optax(clip):
    """make_optimizer + clip_by_global_norm_ against optax's chain of
    clip_by_global_norm and adam with the trainer's schedule
    (lushnerf_tpu/train/trainer.py:208-216), over 4 updates."""
    cfg = types.SimpleNamespace(lrate=5e-3, lrate_decay=0.002, grad_clip_norm=clip)
    rng = np.random.default_rng(4)
    init = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: 0.1 * rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(4)]
    sched_fn = lambda count: cfg.lrate * (0.1 ** (count / (cfg.lrate_decay * 1000.0)))  # noqa: E731
    opt = optax.adam(learning_rate=sched_fn)
    if clip > 0:
        opt = optax.chain(optax.clip_by_global_norm(clip), opt)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jp)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in init.items()})
    topt, tsched = trainer.make_optimizer(cfg, module)
    for step, g in enumerate(grads):
        assert tsched.get_last_lr()[0] == pytest.approx(schedule.lr_at(step, cfg.lrate, cfg.lrate_decay),
                                                        rel=1e-12)
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        if clip > 0:
            norm = trainer.clip_by_global_norm_(module.parameters(), clip)
            assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        topt.step()
        tsched.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def _configs(tiny, backend=None, dtype=None, **extra):
    """(port Config, port LushConfig, JAX Config, JAX LushConfig)."""
    cfg = flagship_cfg(NUM_IMG, tiny=tiny)
    jcfg = ge._flagship_cfg(NUM_IMG, tiny=tiny)
    for c in (cfg, jcfg):
        for k, v in extra.items():
            setattr(c, k, v)
    if backend is not None:
        cfg.mlp_backend, cfg.mlp_compute_dtype = backend, dtype
        jcfg.mlp_backend, jcfg.mlp_compute_dtype = {"torch": "xla", "cuda": "pallas"}[backend], dtype
    return cfg, cfg.lush_config(), jcfg, jcfg.lush_config()


def _batch_both(n, seed):
    rays, idx, fq = _batch(n, seed)
    rgbs = np.random.default_rng(seed + 1).random((n, 3), dtype=np.float32)
    np_batch = {"rays": rays, "rgbs": rgbs, "images_idx": idx[:, None].astype(np.int32),
                "fq_mask": fq}
    return ({k: torch.from_numpy(v) for k, v in np_batch.items()},
            {k: jnp.asarray(v) for k, v in np_batch.items()})


def _jax_step_fns(jlc, jcfg, stage, rnd_j, monkeypatch):
    """(value_and_grad of the JAX Trainer's _loss_fn, its optax optimizer),
    the forwards fed rnd_j."""
    monkeypatch.setattr(jtrainer, "forward_kernel",
                        functools.partial(jl.forward_kernel, rand_override=rnd_j))
    monkeypatch.setattr(jtrainer, "forward_naive",
                        functools.partial(jl.forward_naive, rand_override=rnd_j))
    fake = types.SimpleNamespace(lush_cfg=jlc, H=H, W=W, focal=FOCAL)
    vg = jax.value_and_grad(
        lambda p, b: jtrainer.Trainer._loss_fn(fake, p, b, None, stage), has_aux=True)
    schedule_fn = lambda c: jcfg.lrate * (0.1 ** (c / (jcfg.lrate_decay * 1000.0)))  # noqa: E731
    opt = optax.adam(learning_rate=schedule_fn)
    if jcfg.grad_clip_norm > 0:
        opt = optax.chain(optax.clip_by_global_norm(jcfg.grad_clip_norm), opt)
    return vg, opt


def _grads_by_name(model):
    """Each parameter's grad; zeros where the stage does not reach it (the
    RBK in the naive stage), as JAX's grad gives."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().numpy()
            for n, p in model.named_parameters()}


ALIAS_PREFIXES = ("blur_kernel_net.", "mlp_rbk.view_embedding_layer.")


def _compare_grads(got, want_tree, check):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    # every parameter once: the state dict's other keys are aliases of the shared RBK
    assert set(got) <= set(want)
    assert all(k.startswith(ALIAS_PREFIXES) for k in set(want) - set(got))
    for name, g in got.items():
        check(name, g, want[name].numpy())


@pytest.mark.parametrize("stage,clip", [("naive", 0.0), ("kernel", 0.0), ("allkernel", 0.02)],
                         ids=["naive", "kernel", "allkernel-clip"])
def test_train_step_tiny_flagship_matches_jax(stage, clip, monkeypatch):
    cfg, lc, jcfg, jlc = _configs(tiny=True, grad_clip_norm=clip, **OPTIONAL_TERMS)
    assert lc.rbk_anchor_reg > 0 and lc.rbk_spread_l1 > 0 and lc.snd_l1 > 0
    params = jax_params(jlc, seed=31)
    batch, jbatch = _batch_both(6, seed=32)
    n_rays = 6 if stage == "naive" else 6 * lc.rbk.num_rays_out
    rnd = _draws(lc, n_rays, seed=33)
    rnd_t = {k: torch.from_numpy(v) for k, v in rnd.items()}
    vg, opt = _jax_step_fns(jlc, jcfg, stage, {k: jnp.asarray(v) for k, v in rnd.items()},
                            monkeypatch)
    vg = jax.jit(vg)

    # step-1 grads of every parameter
    (jloss, _), jgrads = vg(params, jbatch)
    model = _model(lc, params)
    loss, _ = trainer.loss_fn(model, lc, H, W, FOCAL, batch, stage, rand_override=rnd_t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    def check(name, g, w):
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_REL or np.abs(g - w).max() <= 1e-9, (name, err)

    _compare_grads(_grads_by_name(model), jgrads, check)

    # params after 3 Adam steps (lr decaying, the optional clip on)
    state = opt.init(params)
    jp = params
    for _ in range(3):
        (_, _), g = vg(jp, jbatch)
        updates, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    model = _model(lc, params)
    topt, tsched = trainer.make_optimizer(cfg, model)
    for _ in range(3):
        trainer.train_step(model, topt, tsched, lc, H, W, FOCAL, batch, stage,
                           rand_override=rnd_t, grad_clip_norm=cfg.grad_clip_norm)
    got = params_to_jax(model.state_dict())
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_step_width256_cuda_bf16_matches_pallas(monkeypatch):
    """The flagship config as shipped (fused path, bf16, stash backward) on
    2 rays, one kernel-stage step's grads against JAX's Pallas kernel in
    interpret mode; the plain versions stand in for the kernels on the CPU."""
    cfg, lc, jcfg, jlc = _configs(tiny=False)
    assert (lc.render.mlp_backend, lc.render.mlp_compute_dtype, lc.render.mlp_bwd) == \
        ("cuda", "bfloat16", "stash")
    _, lc32, _, _ = _configs(tiny=False, backend="cuda", dtype="float32")
    params = jax_params(jlc, seed=41)
    batch, jbatch = _batch_both(2, seed=42)
    rnd = _draws(lc, 2 * lc.rbk.num_rays_out, seed=43)
    vg, _ = _jax_step_fns(jlc, jcfg, "kernel", {k: jnp.asarray(v) for k, v in rnd.items()},
                          monkeypatch)
    with pltpu.force_tpu_interpret_mode():
        (_, _), jgrads = jax.jit(vg)(params, jbatch)
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()}
    got = {}
    for name, c in (("bf16", lc), ("f32", lc32)):
        fused.launches = fused.launches_bwd_stash = 0
        model = _model(c, params)
        loss, _ = trainer.loss_fn(model, c, H, W, FOCAL, batch, "kernel",
                                  rand_override={k: torch.from_numpy(v) for k, v in rnd.items()})
        loss.backward()
        assert fused.launches == fused.launches_bwd_stash == 0
        got[name] = _grads_by_name(model)
    median = {}
    for name, grads in got.items():
        rel = {n: np.abs(g - want[n]).mean() / max(np.abs(want[n]).mean(), 1e-30)
               for n, g in grads.items()}
        median[name] = float(np.median(list(rel.values())))
    for n, g in got["bf16"].items():
        err = np.abs(g - want[n]).max() / max(np.abs(want[n]).max(), 1e-30)
        assert err <= BF16_MAX_REL, (n, err)
    assert median["bf16"] <= BF16_MEDIAN_MEAN_REL, median
    assert median["f32"] > BF16_MEDIAN_MEAN_REL, median  # the bound sees the bf16 rounding
