"""BENCHMARK.json against the benchmark's contract: keys, names, units,
paths, bounds, the check's clock, and that every cell finds its files and
every per-layer metric's cells report the end-to-end metric it moves.

Each rule is a function of a spec given as data and of the benchmark's
directory (`pkg`, whose parent is the checkout's root), and raises
AssertionError where the spec breaks it.  The tests run them on
BENCHMARK.json, on a copy of it with a fourth cell added as files and
entries alone, and on copies that drop a cell's entries."""

import copy
import dataclasses
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import clock, harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
PKG = harness.PKG
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    rule_top_level(SPEC)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_cells_and_metrics_the_issue_names():
    """The rules on the cells as a whole, for any number of them."""
    rule_cells(SPEC)


def entries():
    for key in KEYS:
        for e in SPEC[key]:
            yield key, e


@pytest.mark.parametrize("key,entry", list(entries()), ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_entry_rules(key, entry):
    rule_entry(key, entry)


def test_names_unique():
    rule_names_unique(SPEC)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    rule_per_layer(metric)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    rule_every_cell_reports(SPEC)


def test_layers_are_spelled_alike():
    rule_layers(SPEC)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    rule_cell_files(cell)
    ctx = harness.context(SPEC, cell, 0, None)
    assert ctx.limits and ctx.config["config"]


def test_every_file_of_a_cell_is_named():
    rule_files_are_named(SPEC)


def test_the_check_fits_the_clock():
    rule_clock(SPEC)
    assert clock.admitted(SPEC) <= clock.MOST_CELLS


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


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_reduced_lists_every_key_changed_from_the_source(name):
    rule_reduced(name)


def test_traffic_and_kernel_maps_are_data():
    rule_data(SPEC)


def test_every_rule_holds_on_the_spec():
    """all_rules, which the tests below run on changed specs, passes here."""
    all_rules(SPEC)


# -- a fourth cell, and cells dropped --------------------------------------------

def digests(root: Path) -> dict:
    return {p: hashlib.sha1(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def add_a_cell(pkg: Path, spec: dict) -> str:
    """A fourth cell the documented way (perfbench/README.md, "Adding to
    it"): new configuration, traffic, limits and metric files; new
    `configs`, `workloads` and `per_layer` entries; the cell's name
    appended to the `workloads` lists of the end-to-end metrics it
    reports.  Its set-up does two minutes of work beyond the common ones.
    Returns the cell's name."""
    conf = harness.load_json(pkg / "configs" / "poster.json")
    conf["name"] = "poster_late"
    (pkg / "configs" / "poster_late.json").write_text(json.dumps(conf))
    (pkg / "traffic" / "late.json").write_text(json.dumps(dict(
        harness.load_json(pkg / "traffic" / "train.json"), start_iter=59990,
        setup_extra_s=120)))
    cell = "poster_late.late"
    (pkg / "limits" / f"{cell}.json").write_text(
        (pkg / "limits" / "poster.train.json").read_text())
    (pkg / "metrics" / "rematch_ms.late.py").write_text(
        '"""Host ms of the set-up\'s rematch."""\n\n\ndef read(r):\n'
        '    s = r.setup["spans_s"].get("train.rematch")\n'
        '    return None if s is None else 1e3 * s\n')
    spec["configs"].append({"name": "poster_late", "source": SPEC["configs"][0]["source"],
                            "file": "perfbench/configs/poster_late.json",
                            "reduced": conf["reduced"], "why": "poster, its cell late in a run"})
    spec["workloads"].append({"name": cell, "config": "poster_late", "traffic": "late",
                              "chips": 1, "why": "iterations from 59,991, a rematch in set-up"})
    spec["per_layer"].append({"name": "rematch_ms.late", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "trainer loop",
                              "moves": "train_rays_per_s", "workloads": [cell]})
    for m in spec["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append(cell)
    return cell


def test_a_fourth_cell_passes_every_rule(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    pkg = tmp_path / "perfbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(pkg)
    spec = harness.load_json(tmp_path / "BENCHMARK.json")
    cell = add_a_cell(pkg, spec)
    all_rules(spec, pkg)
    assert {p: d for p, d in digests(pkg).items() if p in before} == before
    assert len(spec["workloads"]) == len(SPEC["workloads"]) + 1
    # its set-up is on the clock: it admits fewer cells than an ordinary one
    assert clock.costs(spec, pkg)[cell] == clock.cell_cost(spec) + 14 * 120
    assert clock.admitted(spec, pkg) < clock.admitted(SPEC)


def drop(spec: dict, cell: str, everywhere: bool) -> dict:
    """The spec without the cell's workloads entry; everywhere: without every
    mention of it too, and without the entries that are then left with no
    cell."""
    spec = copy.deepcopy(spec)
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] != cell]
    if everywhere:
        for key in ("end_to_end", "per_layer"):
            for m in spec[key]:
                if "workloads" in m:
                    m["workloads"] = [c for c in m["workloads"] if c != cell]
            spec[key] = [m for m in spec[key] if m.get("workloads", True)]
        spec["configs"] = [c for c in spec["configs"]
                           if any(w["config"] == c["name"] for w in spec["workloads"])]
    return spec


@pytest.mark.parametrize("everywhere", [False, True], ids=["entry", "everywhere"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_rules_fail_without_a_cells_entries(cell, everywhere):
    with pytest.raises(AssertionError):
        all_rules(drop(SPEC, cell, everywhere))


# -- the rules ----------------------------------------------------------------

def cells_of(spec):
    return [w["name"] for w in spec["workloads"]]


def rule_top_level(spec, pkg=PKG):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)


def rule_cells(spec, pkg=PKG):
    """At most 24 cells; of them at most a quarter, rounded down, on 4 chips,
    and one always may; every configuration has a cell and every cell a
    configuration; setup_s is an end-to-end metric."""
    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    configs = {c["name"] for c in spec["configs"]}
    assert 1 <= len(configs) <= 24
    assert configs == {w["config"] for w in cells}
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}


def rule_entry(key, entry, spec=SPEC, pkg=PKG):
    assert set(entry) - {"workloads"} == KEYS[key]
    assert NAME.match(entry["name"])
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200
            assert "\n" not in entry[text] and "\t" not in entry[text]
    if key == "configs":
        assert any(entry["file"].startswith(p + "/") for p in spec["paths"])
        assert (pkg.parent / entry["file"]).is_file()
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
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        if "roofline" in entry["name"] or "mfu" in entry["name"]:
            assert entry["unit"] == "%"
    if "workloads" in entry:
        assert entry["workloads"] and set(entry["workloads"]) <= set(cells_of(spec))


def rule_names_unique(spec, pkg=PKG):
    for key in ("configs", "workloads"):
        names = [e["name"] for e in spec[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))


def reported_end_to_end(spec, cell):
    cells = cells_of(spec)
    return {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", cells)}


def rule_per_layer(metric, spec=SPEC, pkg=PKG):
    """The metric moves an end-to-end metric that each of its cells reports,
    and its reader is there."""
    assert metric["moves"] in {m["name"] for m in spec["end_to_end"]}
    for cell in metric.get("workloads", cells_of(spec)):
        assert cell in cells_of(spec) and metric["moves"] in reported_end_to_end(spec, cell)
    assert (pkg / "metrics" / f"{metric['name']}.py").is_file()


def rule_every_cell_reports(spec, pkg=PKG):
    """setup_s, another end-to-end metric and a per-layer metric."""
    cells = cells_of(spec)
    for cell in cells:
        e2e = reported_end_to_end(spec, cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", cells) for m in spec["per_layer"])


def rule_layers(spec, pkg=PKG):
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def rule_cell_files(cell, spec=SPEC, pkg=PKG):
    """The cell resolves its configuration file, its traffic file, the
    driver that file names, and its limits file."""
    w = next(w for w in spec["workloads"] if w["name"] == cell)
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    assert harness.load_json(pkg.parent / conf["file"])["config"]
    traffic = harness.load_json(pkg / "traffic" / f"{w['traffic']}.json")
    assert (pkg / "drivers" / f"{traffic['driver']}.py").is_file()
    assert harness.load_json(pkg / "limits" / f"{cell}.json")


def rule_files_are_named(spec, pkg=PKG):
    """Every limits file is a cell's, every configuration file a
    configuration's, every reader a per-layer metric's: a cell whose
    entries went leaves files that no entry names."""
    cells = set(cells_of(spec))
    assert {f.stem for f in (pkg / "limits").glob("*.json")} <= cells
    files = {(pkg.parent / c["file"]).resolve() for c in spec["configs"]}
    assert {f.resolve() for f in (pkg / "configs").glob("*.json")} <= files
    metrics = {m["name"] for m in spec["per_layer"]}
    assert {f.stem for f in (pkg / "metrics").glob("*.py")} <= metrics


def rule_clock(spec, pkg=PKG):
    """Every cell present is charged 14 runs of run_seconds + 60 + its
    traffic's setup_extra_s, and 180 s to compile; they fit, and the budget
    admits at least as many cells as are present."""
    charged = clock.costs(spec, pkg)
    assert set(charged) == set(cells_of(spec))
    assert clock.fixed_s(spec) + sum(charged.values()) <= clock.BUDGET_S
    assert clock.admitted(spec, pkg) >= len(spec["workloads"])


def rule_reduced(name, spec=SPEC, pkg=PKG):
    """`reduced` is the file's, and lists every key changed from the source,
    each with the value it is run at."""
    entry = next(c for c in spec["configs"] if c["name"] == name)
    conf = harness.load_json(pkg.parent / entry["file"])
    assert entry["reduced"] == conf["reduced"]
    assert set(conf["reduced"]) == set(conf["changed_from_source"])
    assert len(conf["reduced"]) <= 16
    for key, (_, run) in conf["changed_from_source"].items():
        assert conf["config"][key] == run, key


def rule_data(spec, pkg=PKG):
    """Traffic mixes and kernel maps are data; every kernel role is read by
    a per-layer metric's reader or by readers.py."""
    for f in (pkg / "traffic").glob("*"):
        assert f.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv")
        json.loads(f.read_text())
    sources = [(pkg / "readers.py").read_text()] + [
        f.read_text() for f in (pkg / "metrics").glob("*.py")]
    for role in harness.kernel_roles(pkg):
        assert any(f'"{role}"' in s or f"'{role}'" in s for s in sources), role


SPEC_RULES = (rule_top_level, rule_cells, rule_names_unique, rule_every_cell_reports,
              rule_layers, rule_files_are_named, rule_clock, rule_data)


def all_rules(spec, pkg=PKG):
    for rule in SPEC_RULES:
        rule(spec, pkg)
    for key in KEYS:
        for e in spec[key]:
            rule_entry(key, e, spec, pkg)
    for m in spec["per_layer"]:
        rule_per_layer(m, spec, pkg)
    for cell in cells_of(spec):
        rule_cell_files(cell, spec, pkg)
    for c in spec["configs"]:
        rule_reduced(c["name"], spec, pkg)
