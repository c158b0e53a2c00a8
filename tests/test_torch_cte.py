"""The port's CTE pass (lushnerf_torch/train/consistency.py and the
consist step, gates, rematch and match tables of train/trainer.py)
against lushnerf_tpu's on the CPU:
  * rays_at_pixels (clamp, floor, pixel-centre ray) within rtol 1e-5 /
    atol 1e-6, and render_aligned_pixels at the tiny flagship config
    within the renderer's 1e-4 (tests/test_torch_lushnerf.py);
  * the consist step's loss (rtol 1e-5) against jax.value_and_grad of the
    JAX Trainer's `_loss_fn_consist`, the main forward's draws injected
    in both; the CTE term's part of every parameter's grad and the scene
    MLPs' grads within 1e-4 of their max (tests/test_torch_train.py's
    limit); at weight 0 the stage's loss and grads unchanged;
  * the gates at noisenerf_start_iter: the pass runs at >=, the weight
    applies at >;
  * a loop crossing the start with a stub matcher: V^2 matcher calls at the
    rematch, match_tables_NNNNNN.npz written, a resumed Trainer reloading
    it bit for bit; tables from match_table_path; matcher = dkm without
    weights falls back as the JAX trainer does.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.models import lushnerf as jl
from lushnerf_tpu.train import consistency as jcons
from lushnerf_tpu.train import trainer as jtrainer
from lushnerf_torch.config import Config
from lushnerf_torch.convert import params_from_jax
from lushnerf_torch.matcher.api import GridStubMatcher, MatchTables
from lushnerf_torch.train import consistency as cons
from lushnerf_torch.train import losses
from lushnerf_torch.train import trainer as tt
from tests.test_torch_convert import jax_params
from tests.test_torch_lushnerf import FOCAL, H, W, _draws, _model
from tests.test_torch_train import GRAD_REL, _batch_both, _configs, _grads_by_name
from tests.test_torch_trainer import tiny_kwargs
from tests.test_train_e2e import synthetic_scene

RAY_RTOL, RAY_ATOL = 1e-5, 1e-6
RENDER_TOL = 1e-4  # tests/test_torch_lushnerf.py's f32 render tolerance
V, N_PIX = 3, 5
K = np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]], np.float32)


def _views(seed):
    """V forward-facing poses and each view's matched pixel coords (some
    outside the image and fractional) and certainties."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (V, 1, 1))
    poses[:, :, 3] = rng.uniform(-0.1, 0.1, (V, 3))
    poses[:, :3, :3] += rng.uniform(-0.05, 0.05, (V, 3, 3)).astype(np.float32)
    pix = rng.uniform(-2.0, W + 2.0, (V, N_PIX, 2)).astype(np.float32)
    cert = rng.uniform(0.5, 1.0, (V, N_PIX)).astype(np.float32)
    return poses, pix, cert


def test_rays_at_pixels_matches_jax():
    poses, pix, _ = _views(0)
    o, d = cons.rays_at_pixels(torch.from_numpy(K), torch.from_numpy(poses),
                               torch.from_numpy(pix), H, W)
    for v in range(V):
        jo, jd = jcons.rays_at_pixels(K, jnp.asarray(poses[v]), jnp.asarray(pix[v]), H, W)
        np.testing.assert_allclose(o[v].numpy(), np.asarray(jo), rtol=RAY_RTOL, atol=RAY_ATOL)
        np.testing.assert_allclose(d[v].numpy(), np.asarray(jd), rtol=RAY_RTOL, atol=RAY_ATOL)


def test_render_aligned_pixels_matches_jax():
    _, lc, _, jlc = _configs(tiny=True)
    params = jax_params(jlc, seed=21)
    poses, pix, _ = _views(1)
    want = jax.jit(functools.partial(jcons.render_aligned_pixels, cfg=jlc, H=H, W=W))(
        params, K=jnp.asarray(K), poses=jnp.asarray(poses), align_pix=jnp.asarray(pix))
    with torch.no_grad():
        got = cons.render_aligned_pixels(_model(lc, params), lc, H, W, torch.from_numpy(K),
                                         torch.from_numpy(poses), torch.from_numpy(pix))
    assert got.shape == (V, N_PIX, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RENDER_TOL, atol=RENDER_TOL)


WEIGHTS = {"after-start": losses.CONSIST_WEIGHT, "at-start": 0.0}


def _step_inputs():
    """Stage allkernel's batch and draws, and a consist batch of V x N_PIX
    pixels (numpy from seeds)."""
    _, lc, _, jlc = _configs(tiny=True)
    batch, jbatch = _batch_both(6, seed=23)
    rnd = _draws(lc, 6 * lc.rbk.num_rays_out, seed=24)
    return lc, jlc, jax_params(jlc, seed=22), batch, jbatch, rnd, _views(2)


@pytest.fixture(scope="module")
def jax_consist_step():
    """For each weight: the JAX Trainer's `_loss_fn_consist` (loss, grads)
    and its stage-only `_loss_fn` grads, under one jit each, the forward's
    draws injected."""
    lc, jlc, params, _, jbatch, rnd, (poses, pix, cert) = _step_inputs()
    fake = types.SimpleNamespace(lush_cfg=jlc, H=H, W=W, focal=FOCAL, K=K,
                                 cfg=types.SimpleNamespace(consist_threshold=0.8))
    fake._loss_fn = lambda p, b, key, stage: jtrainer.Trainer._loss_fn(fake, p, b, key, stage)
    rnd_j = {k: jnp.asarray(v) for k, v in rnd.items()}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "forward_kernel",
                   functools.partial(jl.forward_kernel, rand_override=rnd_j))
        vg = jax.jit(jax.value_and_grad(lambda p, c: jtrainer.Trainer._loss_fn_consist(
            fake, p, jbatch, c, None, "allkernel"), has_aux=True))
        stage = jax.jit(jax.grad(lambda p: fake._loss_fn(p, jbatch, None, "allkernel")[0]))
        stage_grads = params_from_jax(jax.tree.map(np.asarray, stage(params)))
        for name, weight in WEIGHTS.items():
            c = {"poses": jnp.asarray(poses), "align_pix": jnp.asarray(pix),
                 "certainty": jnp.asarray(cert), "weight": jnp.float32(weight)}
            (loss, _), grads = vg(params, c)
            out[name] = (float(loss), params_from_jax(jax.tree.map(np.asarray, grads)),
                         stage_grads)
    return out


@pytest.mark.parametrize("case", list(WEIGHTS))
def test_consist_step_matches_jax_loss_fn_consist(jax_consist_step, case):
    """Stage allkernel with its random draws injected, plus the consist
    render of V x N_PIX rays through the sharp branch at threshold 0.8: the
    loss; the CTE term's part of every parameter's grad (the grad less the
    stage-only grad, in each package; zero outside the scene MLPs); the
    scene MLPs' grads.  (The stage's own grads are held by
    tests/test_torch_train.py.)"""
    weight = WEIGHTS[case]
    lc, _, params, batch, _, rnd, (poses, pix, cert) = _step_inputs()
    jloss, jgrads, jstage = jax_consist_step[case]
    consist = {"K": torch.from_numpy(K), "poses": torch.from_numpy(poses),
               "align_pix": torch.from_numpy(pix), "certainty": torch.from_numpy(cert),
               "weight": weight, "threshold": 0.8}
    rnd_t = {k: torch.from_numpy(v) for k, v in rnd.items()}
    model = _model(lc, params)
    loss, _ = tt.loss_fn(model, lc, H, W, FOCAL, batch, "allkernel", rand_override=rnd_t,
                         consist=consist)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    grads = _grads_by_name(model)
    plain = _model(lc, params)
    ploss, _ = tt.loss_fn(plain, lc, H, W, FOCAL, batch, "allkernel", rand_override=rnd_t)
    ploss.backward()
    pgrads = _grads_by_name(plain)

    def check(name, g, w):
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_REL or np.abs(g - w).max() <= 1e-9, (name, err)

    scene = ("mlp_coarse.", "mlp_fine.")
    assert set(grads) <= set(jgrads)
    for name in grads:
        check(name, grads[name] - pgrads[name], jgrads[name].numpy() - jstage[name].numpy())
        if name.startswith(scene):
            check(name, grads[name], jgrads[name].numpy())
        else:
            np.testing.assert_array_equal(grads[name], pgrads[name], err_msg=name)

    closs = losses.consistency_loss(
        cons.render_aligned_pixels(plain, lc, H, W, consist["K"], consist["poses"],
                                   consist["align_pix"]), consist["certainty"], 0.8)
    assert closs.item() > 0
    same = [np.array_equal(grads[k], pgrads[k]) for k in grads if k.startswith("mlp_fine.")]
    if weight == 0.0:
        assert loss.item() == ploss.item() and all(same)
    else:
        assert loss.item() != ploss.item() and not any(same)


def _trainer(tmp_path, inject=None, **overrides):
    """The tiny trainer; `inject`: a matcher passed to Trainer (overrides
    cfg.matcher)."""
    kw = tiny_kwargs(tmp_path, kernel_start_iter=2, allkernel_start_iter=3, consist_num_pixels=8)
    kw.update(overrides)
    tr = tt.Trainer(Config(**kw), data=synthetic_scene(), matcher=inject, device="cpu")
    tr.setup()
    return tr


def test_gates_at_noisenerf_start(tmp_path, monkeypatch):
    """The pass runs from noisenerf_start_iter on (>=); its weight is 0 at
    that iteration and CONSIST_WEIGHT after it (>)."""
    tr = _trainer(tmp_path, noisenerf_start_iter=5)
    seen = []
    real = tt.render_aligned_pixels

    def counted(*args):
        seen.append(tr.step + 1)
        return real(*args)

    weights = []
    real_batch = tr._sample_consist_batch

    def batch(i):
        out = real_batch(i)
        weights.append((i, out["weight"]))
        return out

    monkeypatch.setattr(tt, "render_aligned_pixels", counted)
    monkeypatch.setattr(tr, "_sample_consist_batch", batch)
    out = tr.train(7)
    assert np.isfinite(out["loss"])
    assert seen == [5, 6, 7]
    assert weights == [(5, 0.0), (6, losses.CONSIST_WEIGHT), (7, losses.CONSIST_WEIGHT)]
    # the consist stream is its own: seeded [seed, 7919], untouched by the batches
    want = np.random.default_rng([tr.cfg.seed, 7919])
    for _ in range(3):
        MatchTables.zeros(len(tr.i_train), 1024).sample_anchor(want, 8)
    assert tr.consist_rng.integers(1 << 30) == want.integers(1 << 30)


class CountingStub(GridStubMatcher):
    calls = 0

    def match(self, img0, img1):
        CountingStub.calls += 1
        return super().match(img0, img1)


def test_loop_rematches_saves_and_resumes(tmp_path):
    """Across the start with a stub matcher: the rematch at
    rematch_interval matches every ordered pair of the train views' renders
    once, writes its tables, and a Trainer resuming from the step's
    checkpoint reloads them bit for bit (the tables at or below the step)."""
    CountingStub.calls = 0
    kw = dict(noisenerf_start_iter=4, rematch_interval=3, i_weights=7, render_factor=2)
    tr = _trainer(tmp_path, inject=CountingStub(n_points=64), **kw)
    out = tr.train(7)
    assert np.isfinite(out["loss"])
    n_train = len(tr.i_train)
    assert CountingStub.calls == n_train ** 2  # one rematch: at 6 (3 is before the start)
    assert sorted(p.name for p in tr.exp_dir.glob("match_tables_*.npz")) == [
        "match_tables_000006.npz"]
    tables = tr.match_tables
    assert tables.kpts.shape == (n_train, n_train, 64, 4)
    # matched at the eval resolution (render_factor 2), stored at the full one
    assert tables.kpts[..., 0].max() > tr.W_eval and tables.kpts[..., 0].max() < tr.W
    assert (tables.certainty == np.float32(0.9)).all()
    resumed = _trainer(tmp_path, **kw)
    assert resumed.start_step == 7 and resumed._matcher is None
    np.testing.assert_array_equal(resumed.match_tables.kpts, tables.kpts)
    np.testing.assert_array_equal(resumed.match_tables.certainty, tables.certainty)
    # tables saved after the checkpoint's step are not the step's
    (tr.exp_dir / "match_tables_000009.npz").write_bytes(b"")
    assert _trainer(tmp_path, **kw).match_tables.kpts.shape == tables.kpts.shape


def test_match_table_path_tables_train(tmp_path):
    n_train = 3
    rng = np.random.default_rng(30)
    tables = MatchTables(kpts=rng.uniform(0, 15, (n_train, n_train, 40, 4)).astype(np.float32),
                         certainty=np.ones((n_train, n_train, 40), np.float32))
    tables.save(tmp_path / "tables.npz")
    tr = _trainer(tmp_path, noisenerf_start_iter=2, matcher="precomputed",
                  match_table_path=str(tmp_path / "tables.npz"))
    assert tr._matcher is None
    np.testing.assert_array_equal(tr.match_tables.kpts, tables.kpts)
    out = tr.train(4)
    assert np.isfinite(out["loss"])


@pytest.mark.parametrize("tables", [False, True], ids=["zero-tables", "match_table_path"])
def test_dkm_without_weights_falls_back(tmp_path, monkeypatch, capsys, tables):
    monkeypatch.delenv("LUSHNERF_DKM_CKPT", raising=False)
    extra = {}
    if tables:
        MatchTables.zeros(3, 16).save(tmp_path / "t.npz")
        extra["match_table_path"] = str(tmp_path / "t.npz")
    tr = _trainer(tmp_path, noisenerf_start_iter=3, matcher="dkm", **extra)
    msg = capsys.readouterr().out
    assert "[CTE] DKM weights unavailable (DKM checkpoint not found" in msg
    assert ("using precomputed match tables" if tables else
            "consistency loss inactive until tables are provided") in msg
    assert tr._matcher is None
    out = tr.train(5)
    assert np.isfinite(out["loss"]) and tr.step == 5
