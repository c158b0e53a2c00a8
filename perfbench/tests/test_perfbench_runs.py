"""Whole runs at a CPU test's size (the look for a chip skipped, the plain
versions of the program's kernels under the same drivers): sound runs come
out correct, the control and every fault the cell can have come out not
correct, and a cell is added by new files alone."""

import hashlib
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import control, harness

CPU = torch.device("cpu")
SEED = 2 ** 31 + 7


def drive(root, spec, cell, seed=SEED, traced=False):
    return harness.drive(spec, cell, seed, 0.2, traced, CPU, time.perf_counter(), root)


@pytest.mark.parametrize("cell", ["poster.train", "flagship.render", "poster.render"])
def test_a_sound_run_is_correct(tiny, cell):
    root, spec = tiny
    res = drive(root, spec, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]
                                   if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", ["poster.train", "flagship.render", "poster.render"])
def test_the_control_is_not_correct(tiny, cell):
    root, spec = tiny
    got = control.readings(spec, cell, SEED, CPU, root)
    limits = harness.load_json(root / "limits" / f"{cell}.json")
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    assert any(v > limits[k] for k, v in got["control"].items()), got


def adam_does_nothing(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def loss_over_half_the_batch(monkeypatch):
    from lushnerf_torch.train import trainer

    real = trainer.photometric_loss

    def half(rgb, rgb0, target):
        n = len(target) // 2
        return real(rgb[:n], rgb0[:n], target[:n])

    monkeypatch.setattr(trainer, "photometric_loss", half)


def a_colour_altered(monkeypatch):
    from lushnerf_torch.models import renderer

    real = renderer.raw2outputs

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        rgb = out.rgb.clone()
        rgb[0] += 1.0 / 255  # one 8-bit level on one ray of every chunk
        return out._replace(rgb=rgb)

    monkeypatch.setattr(renderer, "raw2outputs", altered)


@pytest.mark.parametrize("cell,fault", [
    ("poster.train", adam_does_nothing),
    ("poster.train", loss_over_half_the_batch),
    ("flagship.render", a_colour_altered),
    ("poster.render", a_colour_altered),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    root, spec = tiny
    fault(monkeypatch)
    res = drive(root, spec, cell)
    assert not res["correct"], res["checks"]


def digests(root):
    return {p: hashlib.sha1(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_a_cell_is_added_by_new_files_alone(tiny):
    root, spec = tiny
    before = digests(root)
    conf = json.loads((root / "configs" / "poster.json").read_text())
    conf["config"]["ray_chunk_eval"] = 128
    (root / "configs" / "poster_small_chunk.json").write_text(json.dumps(conf))
    (root / "traffic" / "render_one.json").write_text(json.dumps({"driver": "render",
                                                                 "trace_views": 1}))
    (root / "limits" / "poster_small_chunk.render_one.json").write_text(
        (root / "limits" / "poster.render.json").read_text())
    (root / "metrics" / "views.render_one.py").write_text(
        '"""Views in the window."""\n\n\ndef read(r):\n    return float(r.units)\n')
    (root / "kernels" / "extra.json").write_text(json.dumps({"role": "mlp_fwd",
                                                             "patterns": ["no_such_kernel"]}))
    spec["configs"].append({"name": "poster_small_chunk", "source": "s", "reduced": [],
                            "why": "w", "file": str(root / "configs" / "poster_small_chunk.json")})
    cell = "poster_small_chunk.render_one"
    spec["workloads"].append({"name": cell, "config": "poster_small_chunk",
                              "traffic": "render_one", "chips": 1, "why": "w"})
    spec["per_layer"].append({"name": "views.render_one", "unit": "views", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "render_rays_per_s", "workloads": [cell]})
    for m in spec["end_to_end"]:
        if m["name"] == "render_rays_per_s":
            m["workloads"].append(cell)
    res = drive(root, spec, cell, traced=True)
    assert res["correct"]
    assert res["metrics"]["views.render_one"]["value"] >= 1
    assert "mlp_launches.render" not in res["metrics"]  # listed for the other cells only
    assert {p: d for p, d in digests(root).items() if p in before} == before
    assert "no_such_kernel" in harness.kernel_roles(root)["mlp_fwd"]


def test_jax_loaded_after_the_window_leaves_no_result(tiny, capsys):
    root, spec = tiny
    assert "jax" not in sys.modules
    (root / "metrics" / "loads_jax.render.py").write_text(
        '"""A reader that loads a module named jax."""\n\nimport sys\nimport types\n\n\n'
        'def read(r):\n    sys.modules["jax"] = types.ModuleType("jax")\n')
    spec["per_layer"].append({"name": "loads_jax.render", "unit": "n", "better": "lower",
                              "source": "host_clock", "layer": "device",
                              "moves": "render_rays_per_s", "workloads": ["poster.render"]})
    try:
        assert drive(root, spec, "poster.render", traced=True) is None
    finally:
        sys.modules.pop("jax", None)
    assert "['jax']" in capsys.readouterr().err


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(harness.PKG / "run.py"), "--workload",
                          "poster.render", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "perfbench")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "poster.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", ["poster.train", "flagship.render", "poster.render"])
def test_the_control_at_the_cells_size(card, cell):
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    limits = harness.load_json(harness.PKG / "limits" / f"{cell}.json")
    for seed in (101, 102, 103):
        got = control.readings(spec, cell, seed, card)
        assert all(v <= limits[k] for k, v in got["program"].items()), got
        assert any(v > limits[k] for k, v in got["control"].items()), got


PROBE_DRIVER = '''"""The render driver, saying what its set-up did."""

import time
from pathlib import Path

from perfbench.harness import load_module

Base = load_module(Path(__file__).with_name("render.py"), "perfbench_driver_render_base").Driver


class Driver(Base):
    def setup(self):
        t0 = time.perf_counter()
        super().setup()
        did = {"spans_s": {"render.first_view": time.perf_counter() - t0},
               "counts": {"views": 1}}
        if self.tr["says"] == "returns":
            return did
        self.setup_readings = did
'''


def add_a_setup_reader(root, spec, cells):
    """A reader of the set-up's readings, listed for `cells`."""
    (root / "metrics" / "setup_views.render.py").write_text(
        '"""Views the set-up rendered, and whether it timed them."""\n\n\ndef read(r):\n'
        '    return r.setup["counts"].get("views", 0) + len(r.setup["spans_s"])\n')
    spec["per_layer"].append({"name": "setup_views.render", "unit": "views", "better": "lower",
                              "source": "program_counter", "layer": "device",
                              "moves": "render_rays_per_s", "workloads": cells})


@pytest.mark.parametrize("says", ["returns", "attribute"])
def test_a_drivers_set_up_readings_reach_a_reader(tiny, says):
    root, spec = tiny
    (root / "drivers" / "render_probe.py").write_text(PROBE_DRIVER)
    (root / "traffic" / "render_probe.json").write_text(json.dumps(
        dict(harness.load_json(root / "traffic" / "render.json"), driver="render_probe",
             says=says)))
    (root / "limits" / "poster.render_probe.json").write_text(
        (root / "limits" / "poster.render.json").read_text())
    cell = "poster.render_probe"
    spec["workloads"].append({"name": cell, "config": "poster", "traffic": "render_probe",
                              "chips": 1, "why": "w"})
    next(m for m in spec["end_to_end"] if m["name"] == "render_rays_per_s")["workloads"].append(
        cell)
    add_a_setup_reader(root, spec, [cell, "poster.render"])
    res = drive(root, spec, cell, traced=True)
    assert res["correct"] and res["metrics"]["setup_views.render"]["value"] == 2
    # a driver that says nothing gives the readers empty readings
    res = drive(root, spec, "poster.render", traced=True)
    assert res["metrics"]["setup_views.render"]["value"] == 0


def test_the_train_window_reads_the_programs_spans(tiny):
    root, spec = tiny
    res = drive(root, spec, "poster.train", traced=True)
    step, loop = (res["metrics"][m]["value"] for m in ("step_host_ms.train",
                                                        "loop_host_ms.train"))
    assert step > 0 and loop > 0
