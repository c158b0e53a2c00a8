"""The readings that the correctness limits are set from, on the card at a
cell's own size: for each seed, the program's numbers against the
reference, the control's (the reference in the next lower precision, put
in the program's place) and, for a training cell, the fault "half of the
batch left out" read on the reference put in the program's place.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

Prints one JSON line a seed (and writes them to FILE).  The benchmark's
runs do not run this; `tests/test_perfbench_runs.py` runs it at a test's
size.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness  # noqa: E402


def readings(spec: dict, cell: str, seed: int, device, root=harness.PKG,
             window_s: float = 0.5, witness: bool = False) -> dict:
    """One seed's numbers: program, control and (training) half_batch."""
    import torch

    ctx = harness.context(spec, cell, seed, device, root)
    driver = harness.make_driver(ctx, root)
    driver.setup()
    out = {"seed": seed}
    if ctx.traffic["driver"] == "train":
        driver.release()
        ref = driver.reference({"lin": "f32", "lin_other": "f32"})
        ctl = driver.control()
        half = driver.reference({"lin": "f32", "lin_other": "f32"}, half_batch=True)
        for name, got in (("program", driver.check_data), ("control", ctl), ("half_batch", half)):
            out[name] = _nums(driver.compare(got, ref))
            out[name + "_leaves"] = _leaves(driver.gaps_of(got, ref))
        if witness:
            # the float32 reference's own rounding: it and the program against
            # the reference in float64, leaf by leaf
            f64 = driver.reference({"lin": "f32", "lin_other": "f32"}, dtype=torch.float64)
            out["f32_reference_vs_f64"] = _leaves(driver.gaps_of(ref, f64))
            out["program_vs_f64"] = _leaves(driver.gaps_of(driver.check_data, f64))
    else:
        win = driver.window(window_s)
        driver.release()
        pose, rgb = driver.views[driver.sample(win)]
        ref = driver.reference(pose)
        out["program"] = _nums(driver.compare(torch.as_tensor(rgb, device=ref.device), ref))
        out["control"] = _nums(driver.compare(driver.control(pose), ref))
    return out


def _nums(checks) -> dict:
    return {c.name: c.value for c in checks}


def _leaves(gaps: dict) -> dict:
    return {k: gaps[k] for k in ("loss_gap", "grad_gap_median_leaf", "change_gap_median_leaf",
                                 "grad_gap_worst_leaf", "change_gap_worst_leaf",
                                 "worst_grad_leaf", "worst_change_leaf")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default="")
    ap.add_argument("--witness", action="store_true",
                    help="training: also the float32 reference and the program against float64")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    lines = []
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        row = readings(spec, args.workload, int(s), torch.device("cuda:0"),
                       witness=args.witness)
        row["seconds"] = time.perf_counter() - t0
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
