"""The readings the consist cell's limits are set from, on the card at the
cell's own size: for each seed, the check's numbers of the program and of
the control (the program's matcher with TF32 allowed for the tables, the
steps' reference in TF32), each against the references, with the tables'
keypoint gap by quantile and the certainties' shares beside them.

    python3 perfbench/control_consist.py --seeds 1,2,3 [--out FILE]

Prints one JSON line a seed (and writes them to FILE).  `control.py` runs
the train and render drivers' readings; this runs the consist driver's
(`Driver.readings`).  The benchmark's runs do not run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness  # noqa: E402

CELL = "poster_dkm.consist"


def readings(spec: dict, seed: int, device, root=harness.PKG, cell: str = CELL) -> dict:
    ctx = harness.context(spec, cell, seed, device, root)
    driver = harness.make_driver(ctx, root)
    t0 = time.perf_counter()
    did = driver.setup()
    setup_s = time.perf_counter() - t0
    driver.release()
    row = {"seed": seed, "setup_s": setup_s,
           "setup_spans_s": {k: v for k, v in did["spans_s"].items()
                             if k.startswith(("train.rematch", "rematch.", "dkm.", "sync.dkm"))}}
    row.update(driver.readings())
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control_consist: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    lines = []
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        row = readings(spec, int(s), torch.device("cuda:0"), cell=args.workload)
        row["seconds"] = time.perf_counter() - t0
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(lines) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
