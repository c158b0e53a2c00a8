"""One run of one cell: set-up, the measured window, an optional traced
slice, the check against the reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in BENCHMARK.json names a
configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`); the mix names its driver (`drivers/<name>.py`);
each per-layer metric is a reader (`metrics/<metric name>.py`); the
kernel-name maps are `kernels/*.json`, each naming a layer role; the
correctness limits of a cell are `limits/<cell>.json`.  Adding a cell, a
mix, a metric or a kernel name adds files and edits none.  A driver's
`setup()` may return (or leave as its `setup_readings` attribute) what its
set-up did, host seconds by span name and counts by counter name, and the
readers find it as `Readings.setup`.

The last stdout line is one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last `checks`, each number
compared beside its limit; the same numbers close standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lushnerf_tpu")
CACHE = ROOT / "build" / "perfbench"  # inside the checkout, at a fixed path
TOP_OPS = 10


class NoCard(RuntimeError):
    pass


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Context:
    """What a driver is given: its cell, the parsed files and the seed."""
    cell: str
    config: dict  # configs/<name>.json
    traffic: dict  # traffic/<name>.json
    limits: dict  # limits/<cell>.json
    seed: int
    device: Any  # torch.device


@dataclasses.dataclass
class Readings:
    """What a per-layer metric reads (`metrics/<name>.py`'s `read`)."""
    units: int  # iterations or views completed in the window
    window_s: float
    spans_s: Dict[str, float]  # host seconds in the window by span: the benchmark's, the program's
    launches: Dict[str, int]  # the program's launch counters over the window
    peak_window_bytes: int
    work: Dict[str, float]  # FLOP and bytes a unit: fwd_flop, bwd_flop, fwd_bytes, bwd_bytes, model_flop
    dtype: str  # the configuration's compute dtype, which picks the peak
    trace: Optional[Any]  # devtrace.DeviceTrace of the traced slice
    roles: Dict[str, List[str]]  # kernel-name patterns by role
    # what the driver's set-up did: {"spans_s": {span: host seconds},
    # "counts": {counter: count}}, both empty where it says nothing
    setup: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: {"spans_s": {}, "counts": {}})


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_roles(root: Path = PKG) -> Dict[str, List[str]]:
    """{role: name patterns} from every kernels/*.json ({"role", "patterns"})."""
    roles: Dict[str, List[str]] = {}
    for f in sorted((root / "kernels").glob("*.json")):
        m = load_json(f)
        roles.setdefault(m["role"], []).extend(m["patterns"])
    return roles


def cell_spec(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def context(spec: dict, cell: str, seed: int, device, root: Path = PKG) -> Context:
    w = cell_spec(spec, cell)
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Context(cell=cell, config=load_json(ROOT / conf["file"]),
                   traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
                   limits=load_json(root / "limits" / f"{cell}.json"), seed=seed, device=device)


def make_driver(ctx: Context, root: Path = PKG):
    name = ctx.traffic["driver"]
    return load_module(root / "drivers" / f"{name}.py", f"perfbench_driver_{name}").Driver(ctx)


def setup_readings(driver, returned) -> Dict[str, Dict[str, float]]:
    """What the driver's set-up did: the dict its setup() returned, else its
    `setup_readings` attribute, else nothing; as {"spans_s", "counts"}."""
    got = returned if returned is not None else getattr(driver, "setup_readings", None) or {}
    return {"spans_s": dict(got.get("spans_s", {})), "counts": dict(got.get("counts", {}))}


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


class HostWatch:
    """What the host did over a stretch: seconds in Python's garbage
    collector and its collections, and this process's CPU seconds (all
    threads) against the wall clock's."""

    def __enter__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, None
        self._cpu, self._wall = time.process_time(), time.perf_counter()
        gc.callbacks.append(self._collect)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._collect)
        self.cpu_s = time.process_time() - self._cpu
        self.wall_s = time.perf_counter() - self._wall

    def _collect(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1
            self._t = None

    def describe(self) -> str:
        return (f"gc {self.gc_s:.3f} s in {self.gc_n} collections, CPU {self.cpu_s:.3f} s "
                f"in {self.wall_s:.3f} s")


def card_name() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: none"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def per_layer(spec: dict, cell: str, readings: Readings, root: Path = PKG) -> Dict[str, dict]:
    out = {}
    for m in spec["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        reader = load_module(root / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(tr) -> dict:
    ops = sorted(tr.time_by_name().items(), key=lambda kv: -kv[1])[:TOP_OPS]
    idle = sorted(tr.idle_by_host().items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(spec: dict, cell: str, seed: int, seconds: float, traced: bool, device,
          t_start: float, root: Path = PKG) -> Dict[str, Any]:
    """A run past the look for a chip: returns the result object, and prints
    the checks to standard error.  None when JAX or the JAX package is
    loaded once the window, the check and the per-layer readers are done."""
    import torch

    ctx = context(spec, cell, seed, device, root)
    driver = make_driver(ctx, root)
    cuda = device.type == "cuda"
    did = setup_readings(driver, driver.setup())
    sync(device)
    setup_s = time.perf_counter() - t_start
    with HostWatch() as host:
        win = driver.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr = driver.traced_slice() if traced and cuda else None
    t_check = time.perf_counter()
    driver.release()
    checks = driver.check(win)
    correct = all(c.ok for c in checks)
    parts = sorted(win["parts_ms"])
    print(f"perfbench: set-up {setup_s:.3f} s, window {win['seconds']:.3f} s, "
          f"{win['units']} {driver.unit}s, check {time.perf_counter() - t_check:.3f} s; "
          f"ms a {driver.unit} in the window's parts: min {parts[0]:.2f}, median "
          f"{parts[len(parts) // 2]:.2f}, max {parts[-1]:.2f}; host in the window: "
          f"{host.describe()}; host s by span: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in sorted(win['spans_s'].items()))}",
          file=sys.stderr)
    if tr is not None and tr.units and win["units"]:
        traced_ms, window_ms = tr.span_us / 1e3 / tr.units, 1e3 * win["seconds"] / win["units"]
        ops = len(tr.ops) / tr.units
        print(f"perfbench: traced {traced_ms:.2f} ms a {driver.unit} against the window's "
              f"{window_ms:.2f}, {ops:.1f} device operations a {driver.unit}: tracing adds "
              f"{1e3 * (traced_ms - window_ms) / ops:.2f} us an operation", file=sys.stderr)
    chips = cell_spec(spec, cell)["chips"]
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": chips, "memory_peak_bytes": int(memory_peak)}
    result: Dict[str, Any] = {"correct": correct, "attempted": win["units"],
                              "failed": win["failed"]}
    if traced:
        readings = Readings(units=win["units"], window_s=win["seconds"], spans_s=win["spans_s"],
                            launches=win["launches"], peak_window_bytes=win["peak_bytes"],
                            work=driver.work(), dtype=ctx.config["config"]["mlp_compute_dtype"],
                            trace=tr, roles=kernel_roles(root), setup=did)
        result["metrics"] = per_layer(spec, cell, readings, root)
        if tr is not None:
            device_info["busy_s"] = tr.busy_us / 1e6
            device_info["window_s"] = tr.span_us / 1e6
            result["breakdown"] = breakdown(tr)
    else:
        values = dict(driver.end_to_end(win), setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
    result["device"] = device_info
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    found = forbidden_modules()  # after the window, the check and the readers
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return None
    print(f"perfbench: correct {correct}; the numbers compared, each beside its limit:",
          file=sys.stderr)
    for c in checks:
        print(f"{c.name} {c.value!r} limit {c.limit!r}{'' if c.ok else ' FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return result


def run(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    chips = cell_spec(spec, args.workload)["chips"]

    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(CACHE / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("LUSHNERF_DKM_CKPT", None)  # the run reads nothing outside the checkout
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"needs {chips} CUDA device(s); torch.cuda.is_available() = "
                     f"{torch.cuda.is_available()}, device_count() = "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    print(f"perfbench: {args.workload} seed {args.seed} on {card_name()}", file=sys.stderr,
          flush=True)
    result = drive(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                   t_start)
    if result is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv: List[str], t_start: float) -> int:
    try:
        return run(argv, t_start)
    except NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
