"""The port's trainer (lushnerf_torch/train/trainer.py `Trainer`,
train/checkpoint.py, utils/, run.py) on the CPU, on the tiny synthetic
scene of tests/test_train_e2e.py:
  * Trainer.train equals the same number of train_step calls on the same
    batches, stages and generator, bit for bit;
  * the whole loop against lushnerf_tpu's Trainer on its own params
    (converted), with no random draws in the step (perturb 0, raw noise
    0): the loss at each iteration and the final params within rtol 1e-4 /
    atol 1e-6 (f32 sums in another order through 6 Adam steps), and the
    eval metrics line within rtol 1e-4 (renders at render_factor 2, the
    GT brought down by an area mean against cv2's INTER_AREA);
  * checkpoints bit for bit, resume at the next iteration with the lr of
    lr_at, and a reference `.tar`;
  * compute_img_metric within 1e-6 of lushnerf_tpu's, the TensorBoard
    writer's bytes equal to its, render_warped_view within the render
    tests' 1e-4;
  * eval, render_only, save_warped_ray_img and the CLI write their files;
    the refusal of CTE; the import boundary in a fresh interpreter.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.config import Config as JConfig
from lushnerf_tpu.models import lushnerf as jl
from lushnerf_tpu.train.trainer import Trainer as JTrainer
from lushnerf_tpu.utils import metrics as jmetrics
from lushnerf_tpu.utils import tb_writer as jtb
from lushnerf_torch import run
from lushnerf_torch.config import Config
from lushnerf_torch.convert import params_from_jax
from lushnerf_torch.models import lushnerf as tl
from lushnerf_torch.train import checkpoint as ckpt_lib
from lushnerf_torch.train import schedule
from lushnerf_torch.train import trainer as tt
from lushnerf_torch.utils import metrics
from lushnerf_torch.utils import tb_writer
from tests.test_torch_convert import jax_params
from tests.test_torch_data import write_llff_scene
from tests.test_train_e2e import synthetic_scene

REPO = Path(__file__).resolve().parents[1]
LOOP_RTOL, LOOP_ATOL = 1e-4, 1e-6
METRIC_TOL = 1e-6
RENDER_TOL = 1e-4  # tests/test_torch_lushnerf.py's f32 render tolerance
METRICS_LINE = re.compile(r"^iter(\d+): MSE:(\S+) PSNR:(\S+) SSIM:(\S+) LPIPS:(\S+)$")


def tiny_kwargs(tmp_path, **overrides):
    """tests/test_train_e2e.py's tiny_config, as keyword arguments for
    either package's Config."""
    base = dict(
        expname="test_exp", basedir=str(tmp_path / "logs"), tbdir=str(tmp_path / "logs_tb"),
        N_rand=64, N_samples=18, N_importance=6, netdepth=2, netwidth=16, netdepth_fine=2,
        netwidth_fine=16, multires=4, multires_views=2, use_viewdirs=True, raw_noise_std=1.0,
        rgb_activate="sigmoid", blur_model_type="dpnerf", use_dpnerf=True, rbk_use_origin=True,
        rbk_num_motion=2, rbk_view_embed_ch=8, rbk_enc_brc_width=8, rbk_se_r_width=8,
        rbk_se_v_width=8, rbk_ccw_width=8, tone_mapping_type="gamma", kernel_start_iter=3,
        allkernel_start_iter=6, noisenerf_start_iter=10**9, i_print=2, i_weights=10**9,
        i_testset=10**9, llffhold=4, point_chunk=0, ray_chunk_eval=64, lrate=5e-4,
    )
    base.update(overrides)
    return base


def trainer(tmp_path, **overrides):
    tr = tt.Trainer(Config(**tiny_kwargs(tmp_path, **overrides)), data=synthetic_scene(),
                    device="cpu")
    tr.setup()
    return tr


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _opt_tensors(opt):
    return {f"{i}.{k}": v for i, s in opt.state_dict()["state"].items() for k, v in s.items()}


def _scalars(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def test_train_equals_manual_train_steps(tmp_path):
    """8 iterations across naive -> kernel -> allkernel, with the random
    draws on: the loop is the steps, bit for bit."""
    looped = trainer(tmp_path / "a")
    manual = trainer(tmp_path / "b")
    _assert_bitwise(_state(looped.model), _state(manual.model))
    out = looped.train(8)
    cfg = manual.cfg
    stages = []
    for i in range(1, 9):
        batch = manual.dataset.next_batch(cfg.N_rand, manual.np_rng)
        stage = schedule.stage_for_iter(i, cfg.kernel_start_iter, cfg.allkernel_start_iter)
        stages.append(stage)
        loss, mse = tt.train_step(manual.model, manual.optimizer, manual.scheduler,
                                  manual.lush_cfg, manual.H, manual.W, manual.focal, batch,
                                  stage, manual.generator)
    assert stages == ["naive"] * 2 + ["kernel"] * 3 + ["allkernel"] * 3
    _assert_bitwise(_state(looped.model), _state(manual.model))
    _assert_bitwise(_opt_tensors(looped.optimizer), _opt_tensors(manual.optimizer))
    assert out["loss"] == float(loss) and looped.step == 8
    logged = _scalars(looped.log_file)
    assert [r["step"] for r in logged] == [2, 4, 6, 8]
    assert [r["stage"] for r in logged] == ["naive", "kernel", "allkernel", "allkernel"]


def test_whole_loop_against_jax_trainer(tmp_path, capsys):
    """6 iterations (2 naive, 2 kernel, 2 allkernel) and an eval at the
    6th, from lushnerf_tpu's Trainer's own params: the frequency masks
    equal, the loss at each iteration, the final params and the metrics
    line within the loop's tolerances."""
    kw = tiny_kwargs(tmp_path, perturb=0.0, raw_noise_std=0.0, i_print=1, kernel_start_iter=3,
                     allkernel_start_iter=5, i_testset=6, render_factor=2, tbdir="")
    jtr = JTrainer(JConfig(**dict(kw, basedir=str(tmp_path / "jax"))), data=synthetic_scene())
    jtr.setup()
    tr = tt.Trainer(Config(**dict(kw, basedir=str(tmp_path / "port"))), data=synthetic_scene(),
                    device="cpu")
    tr.setup()
    np.testing.assert_array_equal(tr.frequency_masks, jtr.frequency_masks)
    tr.model.load_state_dict(params_from_jax(jax.device_get(jtr.params)), strict=True)
    jtr.train(6)
    tr.train(6)
    got, want = _scalars(tr.log_file), _scalars(jtr.log_file)
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(1, 7))
    assert [r["stage"] for r in got] == [r["stage"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want],
                               rtol=LOOP_RTOL)
    np.testing.assert_allclose([r["psnr"] for r in got], [r["psnr"] for r in want],
                               rtol=LOOP_RTOL)
    want_sd = params_from_jax(jax.device_get(jtr.params))
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=LOOP_RTOL,
                                   atol=LOOP_ATOL, err_msg=k)
    lines = [METRICS_LINE.match(t.metrics_file.read_text().strip()) for t in (tr, jtr)]
    assert all(lines), [t.metrics_file.read_text() for t in (tr, jtr)]
    assert lines[0].group(1) == lines[1].group(1) == "6"
    np.testing.assert_allclose([float(x) for x in lines[0].groups()[1:4]],
                               [float(x) for x in lines[1].groups()[1:4]], rtol=LOOP_RTOL)
    assert lines[0].group(5) == lines[1].group(5) == "nan"
    assert "**[Evaluation]** iter6: MSE:" in capsys.readouterr().out


def test_debug_nan_check_stops_on_a_nonfinite_loss(tmp_path, monkeypatch):
    tr = trainer(tmp_path, debug_nan_check=True)
    real = tt.train_step

    def nan_step(*args, **kwargs):
        loss, mse = real(*args, **kwargs)
        return loss * float("nan"), mse

    monkeypatch.setattr(tt, "train_step", nan_step)
    with pytest.raises(FloatingPointError, match="iter 1"):
        tr.train(2)


def test_nonfinite_loss_is_reported_at_the_print_cadence(tmp_path, monkeypatch, capsys):
    tr = trainer(tmp_path, i_print=1)
    real = tt.train_step
    monkeypatch.setattr(tt, "train_step",
                        lambda *a, **k: (lambda lm: (lm[0] * float("inf"), lm[1]))(real(*a, **k)))
    out = tr.train(1)
    assert not np.isfinite(out["loss"])
    assert "! [Numerical Error] loss non-finite at iter 1 (stage naive)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_and_resume(tmp_path):
    first = trainer(tmp_path, i_weights=4)
    first.train(4)
    assert ckpt_lib.latest_checkpoint(first.exp_dir).name == "000004.ckpt"
    second = trainer(tmp_path, i_weights=4)
    assert second.start_step == second.step == 4
    _assert_bitwise(_state(second.model), _state(first.model))
    _assert_bitwise(_opt_tensors(second.optimizer), _opt_tensors(first.optimizer))
    cfg = second.cfg
    # the update of iteration 5 runs at the lr of 4 updates before it
    assert second.optimizer.param_groups[0]["lr"] == schedule.lr_at(4, cfg.lrate, cfg.lrate_decay)
    second.train(5)
    assert [r["step"] for r in _scalars(second.log_file)] == [2, 4]  # iteration 5 only, no print
    assert second.step == 5
    assert second.optimizer.param_groups[0]["lr"] == schedule.lr_at(5, cfg.lrate, cfg.lrate_decay)
    # no_reload starts afresh
    assert trainer(tmp_path, i_weights=4, no_reload=True).start_step == 0


def test_resume_from_a_reference_tar(tmp_path):
    """A reference `.tar` ({global_step, network_state_dict} with the
    DataParallel prefix) loads the weights; the optimizer restarts."""
    src = trainer(tmp_path / "src")
    src.train(2)
    sd = {"module." + k: v for k, v in src.model.state_dict().items()}
    tar = tmp_path / "ref.tar"
    torch.save({"global_step": 1234, "network_state_dict": sd}, tar)
    tr = trainer(tmp_path / "dst", ft_path=str(tar))
    assert tr.start_step == 1234
    _assert_bitwise(_state(tr.model), _state(src.model))
    assert tr.optimizer.state_dict()["state"] == {}
    assert tr.optimizer.param_groups[0]["lr"] == tr.cfg.lrate


# ---------------------------------------------------------------------------
# metrics, TensorBoard, the warped renderer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["mse", "psnr", "ssim"])
def test_compute_img_metric_matches_jax(metric):
    rng = np.random.default_rng(3)
    a = rng.random((3, 17, 13, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), -0.05, 1.05)
    for x, y in ((a, b), (a[0], b[0])):
        got = metrics.compute_img_metric(torch.from_numpy(x), torch.from_numpy(y), metric)
        want = jmetrics.compute_img_metric(x, y, metric)
        assert got == pytest.approx(want, rel=METRIC_TOL, abs=METRIC_TOL)
    with pytest.raises(ValueError):
        metrics.compute_img_metric(a, b, "lpips")


@pytest.mark.parametrize("H,W,rf", [(378, 504, 4), (12, 16, 2), (13, 10, 3)],
                         ids=["llff-factor8-rf4", "divisible", "odd"])
def test_gt_at_eval_res_matches_jax(H, W, rf):
    """The eval GT at render_factor rf, where rf divides the image's size
    and where it does not (an LLFF scene at factor 8, 378 x 504, at
    render_factor 4; odd sizes), against the JAX trainer's cv2 INTER_AREA
    resize."""
    images = np.random.default_rng(11).random((3, H, W, 3), dtype=np.float32)
    idx = np.array([0, 2])
    owner = SimpleNamespace(images=images, H=H, W=W, H_eval=H // rf, W_eval=W // rf,
                            device=torch.device("cpu"))
    got = tt.Trainer._gt_at_eval_res(owner, idx)
    want = JTrainer._gt_at_eval_res(owner, idx)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, H // rf, W // rf, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=METRIC_TOL)


def test_tb_writer_bytes_match_jax(tmp_path, monkeypatch):
    for mod in (jtb, tb_writer):
        monkeypatch.setattr(mod.time, "time", lambda: 1_800_000_000.5)
    files = {}
    for name, mod in (("port", tb_writer), ("jax", jtb)):
        with mod.SummaryWriter(tmp_path / name) as w:
            for step, (tag, value) in enumerate([("Train/Loss", 0.123), ("Train/PSNR", 21.5),
                                                 ("Test/SSIM", -0.25)]):
                w.add_scalar(tag, value, step * 100, wall_time=1_800_000_001.25 + step)
            w.add_scalar("Train/Loss", 7.0, 12345)  # wall time from time.time
        (path,) = (tmp_path / name).iterdir()
        files[name] = path
    assert files["port"].name == files["jax"].name
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    assert time.time() == 1_800_000_000.5


def test_render_warped_view_matches_jax():
    cfg = Config(**tiny_kwargs(Path("."), num_images=3))
    lc = cfg.lush_config()
    jlc = JConfig(**tiny_kwargs(Path("."), num_images=3)).lush_config()
    params = jax_params(jlc, seed=5)
    model = tl.LushNeRF(lc, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    size, focal, chunk = 6, 5.0, 40
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    c2w[:, 3] = [0.05, -0.02, 0.1]
    want = jax.jit(lambda p, K, c2w: jl.render_warped_view(p, jlc, size, size, K, c2w, 2, chunk))(
        params, jnp.asarray(K), jnp.asarray(c2w))
    got = tl.render_warped_view(model, lc, size, size, K, c2w, 2, chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RENDER_TOL, atol=RENDER_TOL)


# ---------------------------------------------------------------------------
# files the user gets
# ---------------------------------------------------------------------------


def test_eval_render_only_and_warped_images_write_their_files(tmp_path):
    tr = trainer(tmp_path, render_factor=2)
    res = tr.eval_testset(3)
    assert np.isfinite(res["psnr"]) and -1 <= res["ssim"] <= 1 and np.isnan(res["lpips"])
    out = tr.exp_dir / "testset_000003"
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{v:03d}{s}.png" for v in range(4) for s in ("", "_noise", "_blur"))
    assert METRICS_LINE.match(tr.metrics_file.read_text().strip())
    assert tr.render_only() == {"frames": 1}
    assert sorted(p.name for p in (tr.exp_dir / "renderonly_path_000000").iterdir()) == [
        "path_000.png", "path_000_disp.png"]
    res = tr.render_only(render_test=True)
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
    assert len(list((tr.exp_dir / "renderonly_test_000000").iterdir())) == 8
    assert tr.metrics_file.read_text().splitlines()[-1].startswith("**[Evaluation]** : PSNR:")
    warped = tr.save_warped_ray_img()
    M1 = tr.lush_cfg.rbk.num_rays_out
    assert np.load(warped / "rays_warped.npy").shape == (3, M1, 3, 2)
    assert len(list(warped.glob("*.png"))) == 3 * M1 * 2


def test_cli_trains_resumes_and_renders(tmp_path, capsys):
    """`python -m lushnerf_torch.run` on a scene on disk (LLFF, read with
    imageio and preprocessed with cv2), on the CPU."""
    scene = write_llff_scene(tmp_path / "scene", H=16, W=16)
    kw = tiny_kwargs(tmp_path, datadir=str(scene), i_weights=3, render_factor=2, i_print=3)
    cfg_file = tmp_path / "scene.cfg"
    cfg_file.write_text("\n".join(f"{k} = {v}" for k, v in kw.items() if k != "noisenerf_start_iter")
                        + "\nnoisenerf_start_iter = 5\n")
    argv = ["--config", str(cfg_file)]
    with pytest.raises(NotImplementedError, match="--N_iters 4"):
        run.main(argv + ["--N_iters", "6"], device="cpu")
    out = run.main(argv + ["--N_iters", "3"], device="cpu")
    assert np.isfinite(out["loss"])
    exp = tmp_path / "logs" / "test_exp"
    assert (exp / "000003.ckpt").exists() and (exp / "args.txt").exists()
    run.main(argv + ["--N_iters", "4"], device="cpu")
    assert "Resumed from" in capsys.readouterr().out
    assert run.main(argv + ["--render_only"], device="cpu") == {"frames": 120}
    assert len(list((exp / "renderonly_path_000003").glob("path_*.png"))) == 240
    res = run.main(argv + ["--render_only", "--render_test"], device="cpu")
    assert np.isfinite(res["psnr"])
    assert (run.main(argv + ["--save_warped_ray_img"], device="cpu") / "rays_warped.npy").exists()


def test_cte_range_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="CTE"):
        trainer(tmp_path, N_iters=10, noisenerf_start_iter=10)
    tr = trainer(tmp_path, N_iters=9, noisenerf_start_iter=10)
    with pytest.raises(NotImplementedError, match="--N_iters 9"):
        tr.train(12)
    assert tr.step == 0  # refused before the first iteration
    tr.train(2)  # below it: trains
    # render-only needs no training range
    trainer(tmp_path, N_iters=10**6, noisenerf_start_iter=10, render_only=True).render_only()


def test_port_entry_points_import_no_jax():
    code = ("import sys; import lushnerf_torch.run, lushnerf_torch.train.trainer, "
            "lushnerf_torch.data.llff, lushnerf_torch.data.freq_mask, lushnerf_torch.data.rays, "
            "lushnerf_torch.utils.metrics, lushnerf_torch.utils.tb_writer, "
            "lushnerf_torch.utils.images, lushnerf_torch.train.checkpoint; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'lushnerf_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
