"""The check's clock: what one full check of the benchmark costs, cell by
cell, and how many cells it admits.

    python3 perfbench/clock.py

A check makes 2 + 14 runs a cell.  Each run is allowed `run_seconds` + 60
s, and the seconds of work its set-up does beyond the common imports,
build, scene and weights: its traffic's `setup_extra_s` (default 0).  Each
cell has 2 x 90 s more to compile, and 1,200 s are kept spare; all of it
fits into 43,200 s.  The cells admitted are those present and as many more
as the rest of the budget holds at an ordinary cell's cost (no
`setup_extra_s`), 24 at most.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BUDGET_S = 43200
SPARE_S = 1200
RUNS_A_CELL = 14
RUNS_A_CHECK = 2  # besides the cells'
RUN_ALLOWANCE_S = 60
COMPILE_S = 2 * 90
MOST_CELLS = 24


def run_cost(spec: dict, setup_extra_s: float = 0.0) -> float:
    return spec["run_seconds"] + RUN_ALLOWANCE_S + setup_extra_s


def cell_cost(spec: dict, setup_extra_s: float = 0.0) -> float:
    return RUNS_A_CELL * run_cost(spec, setup_extra_s) + COMPILE_S


def setup_extra_s(spec: dict, cell: dict, root: Path = PKG) -> float:
    """The cell's `setup_extra_s`, from its traffic file."""
    traffic = json.loads((root / "traffic" / f"{cell['traffic']}.json").read_text())
    return float(traffic.get("setup_extra_s", 0))


def costs(spec: dict, root: Path = PKG) -> Dict[str, float]:
    """Seconds of a full check by cell."""
    return {w["name"]: cell_cost(spec, setup_extra_s(spec, w, root)) for w in spec["workloads"]}


def fixed_s(spec: dict) -> float:
    """What a check costs besides its cells."""
    return SPARE_S + RUNS_A_CHECK * run_cost(spec)


def admitted(spec: dict, root: Path = PKG) -> int:
    """The cells present and as many more ordinary ones as the rest of the
    budget holds, at most 24; fewer than those present where they do not
    fit."""
    spent = fixed_s(spec) + sum(costs(spec, root).values())
    more = math.floor((BUDGET_S - spent) / cell_cost(spec))
    return min(MOST_CELLS, len(spec["workloads"]) + more)


def main() -> int:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, s in costs(spec).items():
        print(f"{name}: {s:.0f} s")
    print(f"besides the cells: {fixed_s(spec):.0f} s; an ordinary cell: {cell_cost(spec):.0f} s; "
          f"cells admitted: {admitted(spec)} of {BUDGET_S} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
