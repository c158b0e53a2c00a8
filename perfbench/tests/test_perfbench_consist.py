"""The consist cell (poster_dkm.consist) whole at a CPU test's size: the
tiny copy of the benchmark with the matcher's widths cut to the port's
TINY_DIMS at a 64 x 96 match and 1,024 columns.  A sound run is correct and
reads every metric it lists; the control's steps are not; a program whose
tables, consist rows, aligned render, CTE term or CTE backward are off is
not correct."""

import json
import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import make_tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
CELL = "poster_dkm.consist"
TINY_MATCHER = dict(resnet_width=8, gp_dim=16, feat_dim=16, proj_dim=16, disp_emb=[8, 8, 4, 4, 2],
                    hidden_mult=[1, 1, 1, 1, 2], hs=64, ws=96, max_columns=1024)


@pytest.fixture
def tiny_dkm(tmp_path):
    root = tmp_path / "perfbench"
    spec = make_tiny(root)
    path = root / "configs" / "poster_dkm.json"
    conf = json.loads(path.read_text())
    conf["matcher"].update(TINY_MATCHER)
    path.write_text(json.dumps(conf))
    tr = root / "traffic" / "consist.json"
    tr.write_text(json.dumps(dict(json.loads(tr.read_text()), warm_iters=1, chunk_iters=1,
                                  trace_iters=2)))
    return root, spec


def drive(root, spec, traced=False):
    return harness.drive(spec, CELL, SEED, 0.2, traced, CPU, time.perf_counter(), root)


def test_a_sound_run_is_correct_and_reads_its_metrics(tiny_dkm):
    root, spec = tiny_dkm
    res = drive(root, spec, traced=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    listed = {m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [])}
    own = {n for n in listed if n.endswith(".consist")}
    # on the CPU the train metrics that read kernels or the card's memory find nothing
    assert own | {"loop_host_ms.train", "step_host_ms.train"} <= set(res["metrics"]) <= listed
    assert res["metrics"]["rematch_s.consist"]["value"] >= \
        res["metrics"]["rematch_render_s.consist"]["value"] > 0
    assert 0 < res["metrics"]["dkm_mfu.consist"]["value"] < 100
    res = drive(root, spec)
    assert set(res["metrics"]) == {"train_rays_per_s", "setup_s"}


def test_the_control_is_not_correct(tiny_dkm):
    root, spec = tiny_dkm
    ctx = harness.context(spec, CELL, SEED, CPU, root)
    driver = harness.make_driver(ctx, root)
    driver.setup()
    driver.release()
    got = driver.readings()
    assert got["pairs"][-1][0] == got["pairs"][-1][1] and len(got["pairs"]) == 4
    assert all(v <= ctx.limits[k] for k, v in got["program"].items()), got
    assert any(v > ctx.limits[k] for k, v in got["control"].items()), got
    # the drawn batch makes the CTE term live; a program without it is not correct
    assert got["terms"]["reference"][0] > 0 and min(got["terms"]["cte_pass"][1]) > 0, got
    assert got["no_cte"]["cte_grad_gap"] == 1.0, got
    assert any(v > ctx.limits[k] for k, v in got["no_cte"].items()), got


def tables_shifted(monkeypatch):
    from lushnerf_torch.matcher.dkm.matcher import DKMMatcher

    real = DKMMatcher._to_kpts

    def shifted(self, *args):
        k0, k1, c = real(self, *args)
        return k0, k1 + np.float32(2.0), c  # two pixels over

    monkeypatch.setattr(DKMMatcher, "_to_kpts", shifted)


def consist_rows_elsewhere(monkeypatch):
    from lushnerf_torch.matcher.api import MatchTables

    real = MatchTables.sample_anchor

    def elsewhere(self, rng, n_pix):
        anchor, pix, cert = real(self, rng, n_pix)
        return anchor, pix[::-1].copy(), cert  # the views' pixels in another order

    monkeypatch.setattr(MatchTables, "sample_anchor", elsewhere)


def aligned_render_off(monkeypatch):
    from lushnerf_torch.train import consistency

    real = consistency.rays_at_pixels

    def off(K, c2w, pix, H, W):
        return real(K, c2w, pix + 1.0, H, W)  # one pixel over

    monkeypatch.setattr(consistency, "rays_at_pixels", off)


def cte_term_dropped(monkeypatch):
    from lushnerf_torch.train import trainer as trainer_mod

    real = trainer_mod.consistency_loss
    monkeypatch.setattr(trainer_mod, "consistency_loss", lambda *a, **k: 0.0 * real(*a, **k))


def cte_backward_cut(monkeypatch):
    from lushnerf_torch.train import trainer as trainer_mod

    real = trainer_mod.consistency_loss
    monkeypatch.setattr(trainer_mod, "consistency_loss", lambda *a, **k: real(*a, **k).detach())


def cte_threshold_ignored(monkeypatch):
    from lushnerf_torch.train import trainer as trainer_mod

    real = trainer_mod.consistency_loss
    monkeypatch.setattr(trainer_mod, "consistency_loss", lambda rgb, cert, th: real(rgb, cert, 0.0))


@pytest.mark.parametrize("fault", [tables_shifted, consist_rows_elsewhere, aligned_render_off,
                                   cte_term_dropped, cte_backward_cut, cte_threshold_ignored],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(tiny_dkm, monkeypatch, fault):
    root, spec = tiny_dkm
    fault(monkeypatch)
    res = drive(root, spec)
    assert not res["correct"], res["checks"]


@pytest.mark.card
def test_the_control_at_the_cells_size(card):
    """On the card at the cell's size (three rematches of 625 pairs, ~9
    minutes): the program within every limit, the control past one."""
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    limits = harness.load_json(harness.PKG / "limits" / f"{CELL}.json")
    for seed in (101, 102, 103):
        ctx = harness.context(spec, CELL, seed, card)
        driver = harness.make_driver(ctx)
        driver.setup()
        driver.release()
        got = driver.readings()
        assert all(v <= limits[k] for k, v in got["program"].items()), got
        assert any(v > limits[k] for k, v in got["control"].items()), got
