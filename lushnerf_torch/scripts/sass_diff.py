"""Compares the device code (SASS) of the fused MLP's kernels in two
checkouts' builds, kernel by kernel, to show that a change leaves a
width's kernels as they were.

    python lushnerf_torch/scripts/sass_diff.py --roots PARENT . [--width 256]

Each checkout's libraries must be built (by `kernel_ab.py`, `bwd_digest.py`
or `chip_smoke.py` run from it).  For each of nerf_mlp_fwd, nerf_mlp_bwd
and nerf_mlp_dgrad it takes the newest build of the width in the
checkout's `build/lushnerf_torch/` (`lib<name>-w<width>-*.so`, or, in a
checkout that builds one width only, `lib<name>-<digest>.so`), disassembles
it with `cuobjdump -sass` and compares each kernel's instructions.  Prints
one JSON line: kernels compared, kernels equal, those that differ (with
their instruction counts and where they part) and the names of those in
one build only.  Needs the CUDA toolkit (no card).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

SOURCES = ("nerf_mlp_fwd", "nerf_mlp_bwd", "nerf_mlp_dgrad")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    if default.exists():
        return str(default)
    raise RuntimeError("cuobjdump not found")


def library(root: Path, name: str, width: int) -> Path:
    d = root / "build" / "lushnerf_torch"
    libs = sorted(d.glob(f"lib{name}-w{width}-*.so")) or \
        sorted(p for p in d.glob(f"lib{name}-*.so") if re.fullmatch(rf"lib{name}-[0-9a-f]+\.so", p.name))
    if not libs:
        raise FileNotFoundError(f"no build of {name} at width {width} under {d}")
    return max(libs, key=lambda p: p.stat().st_mtime)


def kernels(lib: Path) -> dict:
    """{kernel name: its SASS instructions, without addresses and encodings}."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:  # an anonymous namespace's mangled name carries a hash of the build
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
            funcs[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name is not None and ins:
            funcs[name].append(ins.group(1))
    return funcs


def main(roots, width: int) -> dict:
    a, b = (Path(r).resolve() for r in roots)
    res = {"roots": list(roots), "width": width, "kernels": 0, "equal": 0, "differ": [],
           "only_one": []}
    for name in SOURCES:
        ka, kb = kernels(library(a, name, width)), kernels(library(b, name, width))
        res["only_one"] += sorted(set(ka) ^ set(kb))
        for k in sorted(set(ka) & set(kb)):
            res["kernels"] += 1
            if ka[k] == kb[k]:
                res["equal"] += 1
                continue
            # where they part: instruction counts, the first differing index and its neighbours
            i = next((j for j, (x, y) in enumerate(zip(ka[k], kb[k])) if x != y),
                     min(len(ka[k]), len(kb[k])))
            res["differ"].append({"kernel": k, "instructions": [len(ka[k]), len(kb[k])],
                                  "first_diff": i, "a": ka[k][max(0, i - 2):i + 3],
                                  "b": kb[k][max(0, i - 2):i + 3]})
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs=2, required=True, help="the two checkouts")
    ap.add_argument("--width", type=int, default=256)
    args = ap.parse_args()
    main(args.roots, args.width)
