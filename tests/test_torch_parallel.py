"""The port's data-parallel training (lushnerf_torch/parallel/, the trainer's
multi-process paths) on the CPU, against lushnerf_tpu/parallel/ and the
JAX Trainer's step:
  * stripe_indices and shard_dataset equal the JAX functions' at every
    pid; each rank's first three batches (its stripe, shuffled by
    default_rng([seed, pid]), then N_rand / world rays a draw) are the JAX
    RayDataset's at that pid, bit for bit, for worlds of 2 and 3 (the
    trainer's own setup, its rank and world patched in; a real world of 2
    below);
  * allgather_stack's interleave and padding against the JAX one for
    uneven stripes (9 pairs on 4 ranks), the rematch's stripes on 4
    simulated ranks against the JAX trainer's, and the fewer-pairs-than-
    ranks branch;
  * the mesh_shape check; initialize without flags; the kernels refuse a
    second card in one process; a world of 1 under gloo trains the same
    bits as no process group;
  * two gloo processes (tests/torch_ddp_worker.py, no JAX in them, every
    process killed if the run outlasts its limit): one step on a fixed
    global batch, each rank on its half, against the JAX Trainer's
    _loss_fn + optax on the whole batch (the grads within 1e-4 of each
    tensor's max magnitude and the params after the step within 2e-6, the
    limits of tests/test_torch_train.py: f32 sums in another order, here
    also a mean of two half-batch means); params bitwise equal across
    ranks; a Trainer across the CTE start with a content-keyed stub: the
    same tables (equal to one process's) and eval metrics on both ranks;
    checkpoints and logs in rank 0's basedir only; a resume mid-CTE where
    rank 1's basedir is empty.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.config import Config as JConfig
from lushnerf_tpu.data.rays import RayDataset as JRayDataset
from lushnerf_tpu.matcher.api import build_match_tables as jbuild_match_tables
from lushnerf_tpu.parallel import distributed as jdist
from lushnerf_tpu.train.trainer import Trainer as JTrainer
from lushnerf_torch.config import Config
from lushnerf_torch.convert import params_from_jax
from lushnerf_torch.data.rays import FIELDS
from lushnerf_torch.matcher.api import build_match_tables
from lushnerf_torch.ops.fused import build
from lushnerf_torch.parallel import distributed as dist
from lushnerf_torch.parallel.mesh import check_mesh_shape
from lushnerf_torch.train import trainer as tt
from tests.test_torch_convert import jax_params
from tests.test_torch_train import GRAD_REL, PARAM_ATOL
from tests.test_torch_trainer import tiny_kwargs
from tests.test_train_e2e import synthetic_scene
from tests.torch_ddp_worker import ContentStub

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 240
# the loop of the two-rank run and of the world-of-1 test: the CTE pass
# from 6, a rematch at 7 (3 train views: 9 ordered pairs, stripes of 5 and
# 4), an eval and a checkpoint at 8 (render_factor 2)
LOOP = dict(N_rand=64, kernel_start_iter=3, allkernel_start_iter=5, noisenerf_start_iter=6,
            rematch_interval=7, consist_num_pixels=8, i_testset=8, i_weights=8, N_iters=8,
            render_factor=2, tbdir="")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _same_metrics(a: list, b: list) -> bool:
    """Eval metric dicts equal value for value (LPIPS is nan on both)."""
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k], equal_nan=True) for k in x)
        for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# stripes and batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,pcount", [(9, 4), (10, 2), (1, 4), (7, 3), (5, 1)])
def test_stripe_indices_match_jax(n, pcount):
    for pid in range(pcount):
        np.testing.assert_array_equal(dist.stripe_indices(n, pid, pcount),
                                      jdist.stripe_indices(n, pid, pcount))


def _fake_world(monkeypatch, rank, world):
    """The trainer sees rank `rank` of `world` without a process group: no
    state to take from a primary, and its tables broadcast to itself."""
    monkeypatch.setattr(dist, "process_index", lambda: rank)
    monkeypatch.setattr(dist, "process_count", lambda: world)
    monkeypatch.setattr(dist, "broadcast_from_primary", lambda obj: obj)
    monkeypatch.setattr(tt.Trainer, "_sync_state", lambda self: None)


def _trainer(tmp_path, **overrides):
    tr = tt.Trainer(Config(**tiny_kwargs(tmp_path, **overrides)), data=synthetic_scene(),
                    device="cpu")
    tr.setup()
    return tr


def _jax_dataset(port_dataset) -> JRayDataset:
    """A JAX RayDataset of the port's rays (pixel coordinates zero: nothing
    here reads them)."""
    arrays = {k: getattr(port_dataset, k).numpy() for k in FIELDS}
    zeros = np.zeros((len(port_dataset), 1), np.float32)
    return JRayDataset(rays_x=zeros, rays_y=zeros, **arrays)


@pytest.mark.parametrize("pcount", [2, 3])
def test_shard_dataset_matches_jax(tmp_path, pcount):
    full = _trainer(tmp_path).dataset
    for pid in range(pcount):
        got = dist.shard_dataset(full, pid, pcount)
        want = jdist.shard_dataset(_jax_dataset(full), pid, pcount)
        assert len(got) == len(want) == len(range(pid, len(full), pcount))
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k))
    assert dist.shard_dataset(full, 0, 1) is full


def _rank_batches(tmp_path, monkeypatch, rank, world, n_rand):
    """The first three batches of rank `rank` in a world of `world`, drawn
    as the trainer's loop draws them, from the trainer's setup."""
    with monkeypatch.context() as m:
        _fake_world(m, rank, world)
        tr = _trainer(tmp_path / f"r{rank}of{world}", N_rand=n_rand)
    assert tr.local_n_rand == tr.cfg.N_rand // world
    return [tr.dataset.next_batch(tr.local_n_rand, tr.np_rng) for _ in range(3)]


@pytest.mark.parametrize("world", [2, 3])
def test_rank_batches_match_jax(tmp_path, monkeypatch, world):
    full = _trainer(tmp_path / "full").dataset
    seed, n_rand = Config().seed, 48
    for pid in range(world):
        got = _rank_batches(tmp_path, monkeypatch, pid, world, n_rand)
        jds = jdist.shard_dataset(_jax_dataset(full), pid, world)
        rng = np.random.default_rng([seed, pid])
        jds.shuffle(rng)
        for b in got:
            want = jds.next_batch(n_rand // world, rng)
            for k in FIELDS:
                np.testing.assert_array_equal(b[k].numpy(), want[k], err_msg=f"{pid} {k}")


# ---------------------------------------------------------------------------
# gathers and the striped rematch
# ---------------------------------------------------------------------------


def test_allgather_interleave_matches_jax(monkeypatch):
    """9 items on 4 ranks: stripes of 3, 2, 2, 2, zero-padded to 3."""
    items = np.arange(9 * 2, dtype=np.float32).reshape(9, 2) + 1
    stripes = np.stack([np.concatenate([items[p::4], np.zeros((3 - len(items[p::4]), 2),
                                                               np.float32)]) for p in range(4)])
    got = dist.interleave(torch.from_numpy(stripes), 9).numpy()
    from jax.experimental import multihost_utils

    monkeypatch.setattr(multihost_utils, "process_allgather", lambda local: stripes)
    want = jdist.allgather_stack(stripes[0], 9, pid=0, pcount=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, items)
    # one process: the stripe is everything, numpy in, numpy out
    out = dist.allgather_stack(items, 9)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, items)


def _renders(v):
    return np.random.default_rng(5).random((v, 6, 8, 3), dtype=np.float32)


def test_striped_tables_on_four_ranks_match_jax(monkeypatch):
    """The rematch's 9 ordered pairs (3 views) on 4 simulated ranks: each
    rank's matches, padded, interleaved, are one process's tables and the
    JAX trainer's, whose stripes are gathered the same way."""
    renders, world = _renders(3), 4
    locals_port, locals_jax = [], []

    def capture(into):
        def gather(local, n_total, *args, **kwargs):
            into.append(np.asarray(local))
            return np.zeros((n_total, *np.shape(local)[1:]), np.asarray(local).dtype)
        return gather

    for pid in range(world):
        with monkeypatch.context() as m:
            m.setattr(dist, "allgather_stack", capture(locals_port))
            tt.Trainer._build_tables_striped(
                SimpleNamespace(rank=pid, world=world, _matcher=ContentStub()), renders)
            m.setattr(jdist, "allgather_stack", capture(locals_jax))
            m.setattr(jdist, "stripe_indices", lambda n, p=pid: np.arange(p, n, world))
            JTrainer._build_tables_striped(SimpleNamespace(pcount=world, _matcher=ContentStub()),
                                           renders)
    for got, want in zip(locals_port, locals_jax):
        np.testing.assert_array_equal(got, want)
    assert [a.shape[0] for a in locals_port] == [3] * 8  # kpts, cert of each rank
    kpts = dist.interleave(torch.from_numpy(np.stack(locals_port[0::2])), 9).numpy()
    cert = dist.interleave(torch.from_numpy(np.stack(locals_port[1::2])), 9).numpy()
    single = build_match_tables(ContentStub(), renders)
    np.testing.assert_array_equal(kpts.reshape(single.kpts.shape), single.kpts)
    np.testing.assert_array_equal(cert.reshape(single.certainty.shape), single.certainty)


def test_fewer_pairs_than_ranks_builds_the_whole_table():
    renders = _renders(1)  # 1 ordered pair, 4 ranks
    got = tt.Trainer._build_tables_striped(
        SimpleNamespace(rank=2, world=4, _matcher=ContentStub()), renders)
    want = jbuild_match_tables(ContentStub(), renders)
    assert got.kpts.shape[:2] == (1, 1)
    np.testing.assert_array_equal(got.kpts, want.kpts)
    np.testing.assert_array_equal(got.certainty, want.certainty)


# ---------------------------------------------------------------------------
# the mesh, initialize, a world of 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,world,ok", [("", 1, True), ("", 3, True), ("2", 2, True),
                                            ("2,2", 4, True), ("1", 1, True), ("8", 1, False),
                                            ("4", 2, False), ("1", 2, False), ("2,0", 0, False)])
def test_mesh_shape_check(shape, world, ok):
    if ok:
        assert int(np.prod(check_mesh_shape(shape, world))) == world
    else:
        with pytest.raises(ValueError, match="mesh_shape"):
            check_mesh_shape(shape, world)


def test_trainer_refuses_a_mesh_larger_than_the_world(tmp_path):
    with pytest.raises(ValueError, match="mesh_shape '8'"):
        tt.Trainer(Config(**tiny_kwargs(tmp_path, mesh_shape="8")), device="cpu")


def test_initialize_without_flags_or_env_is_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize(device="cpu") is False
    assert (dist.process_index(), dist.process_count(), dist.is_primary()) == (0, 1, True)
    with pytest.raises(ValueError, match="one process per card"):
        dist.initialize("127.0.0.1:1", 2, 0, local_device_ids="0,1")
    with pytest.raises(ValueError, match="num_processes"):
        dist.initialize("127.0.0.1:1", device="cpu")


def test_kernels_refuse_a_second_card(monkeypatch):
    """The kernels' libraries set their attributes once a process, for one
    card: a launch on another card raises before it runs."""
    monkeypatch.setattr(build, "_DEVICE", None)
    build.claim_device(1)
    build.claim_device(1)
    with pytest.raises(RuntimeError, match="one process per card"):
        build.claim_device(0)


def test_cli_with_the_coordinator_flags(tmp_path):
    """`run.main` with --coordinator_address / --num_processes /
    --process_id brings up a process group of 1 (gloo on the CPU), trains
    with it and takes it down at its end."""
    from lushnerf_torch import run
    from tests.test_torch_data import write_llff_scene

    kw = tiny_kwargs(tmp_path, datadir=str(write_llff_scene(tmp_path / "scene", H=16, W=16)),
                     i_weights=3, i_print=3, mesh_shape="1")
    cfg_file = tmp_path / "scene.cfg"
    cfg_file.write_text("\n".join(f"{k} = {v}" for k, v in kw.items()))
    argv = ["--config", str(cfg_file), "--N_iters", "3", "--coordinator_address",
            f"127.0.0.1:{_free_port()}", "--num_processes", "1", "--process_id", "0"]
    out = run.main(argv, device="cpu")
    assert np.isfinite(out["loss"]) and not dist.in_group()
    assert (tmp_path / "logs" / "test_exp" / "000003.ckpt").exists()


def _loop_trainer(tmp_path):
    tr = tt.Trainer(Config(**tiny_kwargs(tmp_path, **LOOP)), data=synthetic_scene(),
                    matcher=ContentStub(), device="cpu")
    tr.setup()
    evals = []
    real = tr.eval_testset
    tr.eval_testset = lambda i, save=True: evals.append(real(i, save)) or evals[-1]
    return tr, evals


def test_world_of_one_under_gloo_is_bitwise(tmp_path):
    """8 iterations across the CTE start (rematch, eval, checkpoint) in a
    process group of 1 (the explicit flags): the all-reduce and the
    striped paths run and give the bits of no process group."""
    assert dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        assert dist.in_group() and dist.process_count() == 1
        grouped, g_evals = _loop_trainer(tmp_path / "group")
        grouped.train()
    finally:
        torch.distributed.destroy_process_group()
    assert not dist.in_group()
    alone, a_evals = _loop_trainer(tmp_path / "alone")
    alone.train()
    _assert_bitwise(_state(grouped.model), _state(alone.model))
    assert np.array_equal(grouped.match_tables.kpts, alone.match_tables.kpts)
    assert grouped.match_tables.certainty.max() > 0
    assert len(g_evals) == 1 and _same_metrics(g_evals, a_evals)


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------


def _global_batch(n, hwf, num_images, seed=41):
    rng = np.random.default_rng(seed)
    rays_o = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    rays_d = rng.standard_normal((n, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5
    return {"rays": np.stack([rays_o, rays_d], axis=-1),
            "rgbs": rng.random((n, 3), dtype=np.float32),
            "images_idx": rng.integers(0, num_images, (n, 1)).astype(np.int32),
            "fq_mask": rng.integers(0, 2, n).astype(bool)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Runs both workers; returns (their results, the step's inputs)."""
    tmp = tmp_path_factory.mktemp("ddp")
    scene = synthetic_scene()
    np.savez(tmp / "scene.npz", **{k: v for k, v in scene.items() if k != "hwf"})
    step_kwargs = tiny_kwargs(tmp, perturb=0.0, raw_noise_std=0.0)
    jlc = JConfig(**dict(step_kwargs, num_images=len(scene["images"]))).lush_config()
    params = jax_params(jlc, seed=17)
    torch.save(params_from_jax(jax.device_get(params)), tmp / "init.pt")
    batch = _global_batch(8, scene["hwf"], len(scene["images"]))
    np.savez(tmp / "batch.npz", **batch)
    spec = {"world": 2, "addr": "127.0.0.1", "port": _free_port(), "out": str(tmp),
            "scene": str(tmp / "scene.npz"), "hwf": list(scene["hwf"]),
            "step_kwargs": step_kwargs, "init": str(tmp / "init.pt"),
            "batch": str(tmp / "batch.npz"), "stage": "kernel",
            "loop_kwargs": tiny_kwargs(tmp, **LOOP)}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_ddp_worker.py"),
                               str(tmp / "spec.json"), str(r)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, SimpleNamespace(params=params, jlc=jlc, batch=batch, hwf=scene["hwf"],
                                  kwargs=step_kwargs, stage=spec["stage"])


def test_two_rank_step_matches_jax_on_the_whole_batch(two_ranks):
    ranks, s = two_ranks
    H, W, focal = s.hwf
    fake = SimpleNamespace(lush_cfg=s.jlc, H=H, W=W, focal=focal)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JTrainer._loss_fn(fake, p, b, jax.random.PRNGKey(0), s.stage), has_aux=True))
    (jloss, _), jgrads = vg(s.params, {k: jnp.asarray(v) for k, v in s.batch.items()})
    cfg = Config(**s.kwargs)
    assert cfg.grad_clip_norm == 0.0
    opt = optax.adam(lambda c: cfg.lrate * 0.1 ** (c / (cfg.lrate_decay * 1000.0)))
    updates, _ = opt.update(jgrads, opt.init(s.params), s.params)
    want_params = params_from_jax(jax.device_get(optax.apply_updates(s.params, updates)))
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for r in ranks:  # the loss is the global batch's mean on both ranks
        np.testing.assert_allclose(r["step_loss"], float(jloss), rtol=1e-5)
    for name, g in ranks[0]["step_grads"].items():
        w = want_grads[name].numpy()
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_REL or np.abs(g.numpy() - w).max() <= 1e-9, (name, err)
    for k, v in ranks[0]["step_params"].items():
        np.testing.assert_allclose(v.numpy(), want_params[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_two_ranks_keep_the_same_params(two_ranks):
    (r0, r1), _ = two_ranks
    for key in ("step_params", "params", "resumed_params"):
        _assert_bitwise(r0[key], r1[key])
    assert r0["jax_imported"] == r1["jax_imported"] == []


def test_two_rank_batches_are_the_jax_processes(two_ranks, tmp_path, monkeypatch):
    """A real world of 2: each rank's stripe and first batches are those of
    the trainer's setup at that rank, which the JAX functions give."""
    (r0, r1), _ = two_ranks
    full = 3 * 16 * 16  # 3 train views of 16 x 16
    for rank, r in enumerate((r0, r1)):
        assert r["dataset_rays"] == full // 2 and r["local_n_rand"] == LOOP["N_rand"] // 2
        want = _rank_batches(tmp_path, monkeypatch, rank, 2, LOOP["N_rand"])
        for got_b, want_b in zip(r["first_batches"], want):
            for k in FIELDS:
                assert torch.equal(got_b[k], want_b[k]), (rank, k)


def test_two_ranks_build_the_same_tables_and_metrics(two_ranks):
    (r0, r1), _ = two_ranks
    for a, b in zip(r0["tables"], r1["tables"]):
        assert np.array_equal(a, b)
    assert r0["tables"][1].max() > 0  # the rematch at 7 ran
    assert r0["striped_equals_single"] and r1["striped_equals_single"]
    assert len(r0["evals"]) == 1 and _same_metrics(r0["evals"], r1["evals"])
    assert np.isfinite(r0["evals"][0]["psnr"])
    assert r0["train"] == r1["train"] and np.isfinite(r0["train"]["loss"])


def test_rank_zero_alone_writes_and_every_rank_resumes_from_it(two_ranks):
    (r0, r1), _ = two_ranks
    assert r1["files"] == []
    assert {"test_exp/000008.ckpt", "test_exp/match_tables_000007.npz", "test_exp/args.txt",
            "test_exp/scalars.jsonl", "test_exp/test_metrics.txt",
            "test_exp/testset_000008/000.png"} <= set(r0["files"])
    for r in (r0, r1):
        assert r["resumed_step"] == 8
        assert r["resumed_params_equal"] and r["resumed_tables_equal"]
    assert r0["resumed_lr"] == r1["resumed_lr"]
