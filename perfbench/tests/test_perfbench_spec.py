"""BENCHMARK.json against the benchmark's contract: keys, names, units,
paths, bounds, and that every per-layer metric's cells report the
end-to-end metric it moves and find its reader."""

import dataclasses
import json
import re

import pytest

from perfbench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_cells_and_metrics_the_issue_names():
    assert CELLS == ["poster.train", "flagship.render", "poster.render"]
    assert {c["name"] for c in SPEC["configs"]} == {"poster", "flagship"}
    assert [m["name"] for m in SPEC["end_to_end"]] == ["train_rays_per_s", "render_rays_per_s",
                                                      "setup_s"]
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[key]:
            yield key, e


@pytest.mark.parametrize("key,entry", list(entries()), ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_entry_rules(key, entry):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[key]
    assert set(entry) - {"workloads"} == keys
    assert NAME.match(entry["name"])
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text] and "\t" not in entry[text]
    if key == "configs":
        assert entry["file"].startswith("perfbench/") and (harness.ROOT / entry["file"]).is_file()
        assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or "width" in k for k in entry["reduced"])
    if key == "workloads":
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4)
    if key in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "per_layer":
        assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in entry["name"] or "mfu" in entry["name"]:
            assert entry["unit"] == "%"


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def reported_end_to_end(cell):
    return {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS and metric["moves"] in reported_end_to_end(cell)
    assert (harness.PKG / "metrics" / f"{metric['name']}.py").is_file()


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = reported_end_to_end(cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in SPEC["per_layer"])


def test_layers_are_spelled_alike():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    ctx = harness.context(SPEC, cell, 0, None)
    assert (harness.PKG / "drivers" / f"{ctx.traffic['driver']}.py").is_file()
    assert ctx.limits and ctx.config["config"]


def test_the_check_fits_the_clock():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_poster_is_the_shipped_file():
    from lushnerf_torch.config import Config

    conf = harness.load_json(harness.PKG / "configs" / "poster.json")
    ours = Config(**conf["config"])
    shipped = Config.from_file(harness.ROOT / "configs" / "poster")
    paths = {"config", "expname", "basedir", "tbdir", "datadir"}
    for f in dataclasses.fields(Config):
        if f.name not in paths:
            assert getattr(ours, f.name) == getattr(shipped, f.name), f.name


def test_flagship_is_flagship_cfg():
    from lushnerf_torch.config import Config, flagship_cfg

    conf = harness.load_json(harness.PKG / "configs" / "flagship.json")
    poster = harness.load_json(harness.PKG / "configs" / "poster.json")
    ours = Config(**conf["config"], num_images=conf["scene"]["views"])
    shipped = flagship_cfg(num_images=29)
    shipped.ray_chunk_eval = 16384  # the runtime key the cell sets (PERF.md, section 4)
    # what a render reads is flagship_cfg's
    assert ours.render_config() == shipped.render_config()
    assert ours.render_config(True) == shipped.render_config(True)
    assert ours.ray_chunk_eval == shipped.ray_chunk_eval
    assert dataclasses.replace(ours.lush_config(), rbk=None, rbk_anchor_reg=0.0) == \
        dataclasses.replace(shipped.lush_config(), rbk=None, rbk_anchor_reg=0.0)
    # every key it changes from configs/poster is one of the render path's
    differ = {k for k in conf["config"] if conf["config"][k] != poster["config"][k]}
    assert differ == {"mlp_backend", "mlp_compute_dtype", "mlp_bwd", "point_chunk",
                      "ray_chunk_eval", "render_rmnearplane"}
    assert set(conf["config"]) == set(poster["config"])


@pytest.mark.parametrize("name", ["poster", "flagship"])
def test_reduced_lists_every_key_changed_from_the_source(name):
    conf = harness.load_json(harness.PKG / "configs" / f"{name}.json")
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    assert entry["reduced"] == conf["reduced"]
    assert set(conf["reduced"]) == set(conf["changed_from_source"])
    assert len(conf["reduced"]) <= 16
    for key, (_, run) in conf["changed_from_source"].items():
        assert conf["config"][key] == run, key


def test_traffic_and_kernel_maps_are_data():
    for f in (harness.PKG / "traffic").glob("*"):
        assert f.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv")
        json.loads(f.read_text())
    roles = harness.kernel_roles()
    assert set(roles) == {"mlp_fwd", "mlp_bwd"}
