"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See perfbench/README.md.  Needs the CUDA cards the cell asks for; without
them it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, heads the import path: the
# program's package and `perfbench` are both found there
sys.path[0] = str(ROOT)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
