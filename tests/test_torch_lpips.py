"""lushnerf_torch/utils/lpips.py against lushnerf_tpu/utils/lpips.py on the
CPU, on random AlexNet and head weights written by `torch.save` and read
through both packages' `load_weights`: `lpips_pair` at 64x64 (rtol 1e-5,
the same convolutions summed in another order), `compute_img_metric(...,
"lpips")` on both, the uniform heads with their warning when only the
trunk is found, the status functions; and the trainer's eval: nan with
`unavailable_reason()` printed without weights, the metric with them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.utils import lpips as jlp
from lushnerf_tpu.utils import metrics as jmetrics
from lushnerf_torch.config import Config
from lushnerf_torch.train import trainer as tt
from lushnerf_torch.utils import lpips as tlp
from lushnerf_torch.utils import metrics
from tests.test_torch_trainer import synthetic_scene, tiny_kwargs

RTOL = 1e-5
ENV = ("LPIPS_ALEX_PATH", "LPIPS_LINEAR_PATH")


def write_weights(tmp_path, seed=0):
    """(trunk path, heads path): torchvision's AlexNet `features.*` keys and
    the v0.1 heads' `lin{i}.model.1.weight` [1, C, 1, 1], drawn at init
    scales from a numpy seed (heads positive, as the published ones)."""
    rng = np.random.default_rng(seed)
    trunk, cin = {}, 3
    for i, (oc, k, _, _) in zip(tlp._ALEX_CONV_IDS, tlp._ALEX_CONVS):
        bound = 1.0 / np.sqrt(cin * k * k)
        trunk[f"features.{i}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, (oc, cin, k, k)).astype(np.float32))
        trunk[f"features.{i}.bias"] = torch.from_numpy(
            rng.uniform(-bound, bound, oc).astype(np.float32))
        cin = oc
    heads = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(0.0, 0.1, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(tlp._STAGE_CHANNELS)}
    torch.save(trunk, tmp_path / "alexnet.pth")
    torch.save(heads, tmp_path / "alex_v01.pth")
    return str(tmp_path / "alexnet.pth"), str(tmp_path / "alex_v01.pth")


@pytest.fixture
def no_lpips_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jlp, "_cache", {})
    monkeypatch.setattr(tlp, "_cache", {})
    return monkeypatch


def _pair(seed, hw=64):
    rng = np.random.default_rng(seed)
    a = rng.random((hw, hw, 3), dtype=np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


def test_lpips_pair_matches_jax(tmp_path):
    alex, lin = write_weights(tmp_path)
    jparams = jlp.load_weights(alex, lin)
    tparams = tlp.load_weights(alex, lin, device="cpu")
    a, b = _pair(1)
    want = jax.jit(jlp.lpips_pair)(jparams, jnp.asarray(a * 2 - 1), jnp.asarray(b * 2 - 1))
    got = tlp.lpips_pair(tparams, torch.from_numpy(a * 2 - 1), torch.from_numpy(b * 2 - 1))
    assert float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    same = tlp.lpips_pair(tparams, torch.from_numpy(a), torch.from_numpy(a))
    assert same.item() == 0.0


def test_compute_img_metric_lpips_matches_jax(tmp_path, no_lpips_env):
    alex, lin = write_weights(tmp_path, seed=1)
    no_lpips_env.setenv("LPIPS_ALEX_PATH", alex)
    no_lpips_env.setenv("LPIPS_LINEAR_PATH", lin)
    assert tlp.status() == jlp.status()
    assert tlp.unavailable_reason() is None and tlp.available()
    a, b = (np.stack(x) for x in zip(_pair(2, 48), _pair(3, 48)))
    want = jmetrics.compute_img_metric(a, b, "lpips")
    got = metrics.compute_img_metric(torch.from_numpy(a), torch.from_numpy(b), "lpips")
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_uniform_heads_when_only_the_trunk_is_found(tmp_path, no_lpips_env):
    alex, _ = write_weights(tmp_path, seed=2)
    no_lpips_env.setenv("LPIPS_ALEX_PATH", alex)
    assert tlp.status() == jlp.status()
    assert tlp.unavailable_reason() == jlp.unavailable_reason()
    assert "linear heads" in tlp.unavailable_reason()
    with pytest.warns(UserWarning, match="uniform"):
        tparams = tlp.load_weights(device="cpu")
    with pytest.warns(UserWarning, match="uniform"):
        jparams = jlp.load_weights()
    a, b = _pair(4, 40)
    want = jlp.lpips_pair(jparams, jnp.asarray(a * 2 - 1), jnp.asarray(b * 2 - 1))
    got = tlp.lpips_pair(tparams, torch.from_numpy(a * 2 - 1), torch.from_numpy(b * 2 - 1))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_without_weights_lpips_is_unavailable(no_lpips_env):
    assert tlp.status() == jlp.status()
    assert tlp.unavailable_reason() == jlp.unavailable_reason()
    assert not tlp.available()
    a, b = _pair(5, 16)
    with pytest.raises(tlp.LPIPSUnavailable, match="LPIPS_ALEX_PATH"):
        metrics.compute_img_metric(a, b, "lpips")


def test_eval_reports_lpips_or_nan_with_the_reason(tmp_path, no_lpips_env, capsys):
    # 32 x 32 at the eval: AlexNet's stages need at least 31 pixels a side
    tr = tt.Trainer(Config(**tiny_kwargs(tmp_path, render_factor=1)),
                    data=synthetic_scene(H=32, W=32), device="cpu")
    tr.setup()
    res = tr.eval_testset(1, save=False)
    assert np.isnan(res["lpips"]) and tlp.unavailable_reason() in capsys.readouterr().out
    alex, lin = write_weights(tmp_path, seed=3)
    no_lpips_env.setenv("LPIPS_ALEX_PATH", alex)
    no_lpips_env.setenv("LPIPS_LINEAR_PATH", lin)
    res = tr.eval_testset(2, save=False)
    rgbs = torch.stack([tr.render_pose(tr.poses[i])[0] for i in tr.i_test])
    want = metrics.compute_img_metric(rgbs, tr._gt_at_eval_res(tr.i_test), "lpips")
    assert np.isfinite(res["lpips"]) and res["lpips"] == pytest.approx(want, rel=1e-6)
    assert "LPIPS unavailable" not in capsys.readouterr().out
