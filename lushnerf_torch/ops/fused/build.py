"""Builds a CUDA source under `lushnerf_torch/csrc/` with nvcc and loads it
with ctypes.

`csrc/<name>.cu` becomes `build/lushnerf_torch/lib<name>-<digest>.so` at
the repository root, compiled for Hopper (`sm_90a`) at first use; the
digest covers the source, the shared `csrc/*.cuh` headers and the flags, so
an edited source is rebuilt (and a source that includes another `.cu`
file, as `nerf_mlp_dgrad_wide.cu` builds the dgrads again for the PEs with
a part of 128 channels, when either changes).  The fused MLP's sources are built once for
each width a launch asks for (`-DNERF_MLP_WIDTH=<width>`, in the digest
and in the file name: `lib<name>-w<width>-<digest>.so`), and every build
of a source can be loaded beside the others in one process.  `build_all`
compiles several sources (or (source, width) pairs) at once, one nvcc
process each.
The sources have a plain C interface and include no PyTorch header, so a
build takes seconds.  Nothing here runs at import time, and this module
imports no PyTorch: builds can run ahead of a run, in a process of their own,

    python -m lushnerf_torch.ops.fused.build [--json OUT] NAME[@wWIDTH] ...

(`nerf_mlp_dgrad@w128`), which compiles them side by side and writes each
one's nvcc output to OUT as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "lushnerf_torch"
# --split-compile=0: the device code's optimisation runs on all host cores,
# as a source's kernel instantiations otherwise compile one by one.
# -fno-gnu-unique: C++ inline and template statics are otherwise GNU unique
# symbols, which the dynamic linker shares between libraries, so that two
# builds of one source in a process (widths 256 and 128) would share, say,
# K1's once-a-process shared-memory attribute flag (host code only)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique", "-Xptxas", "-v",
    "--split-compile=0",
)

_LIBS: Dict[str, ctypes.CDLL] = {}  # by label: a name, or `<name>@w<width>`
# the card this process's kernels launch on (`claim_device`)
_DEVICE: Optional[int] = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(width: Optional[int]) -> Tuple[str, ...]:
    return NVCC_FLAGS if width is None else (*NVCC_FLAGS, f"-DNERF_MLP_WIDTH={int(width)}")


def _target(name: str, width: Optional[int] = None) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes() + " ".join(_flags(width)).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers the sources include
        h.update(header.read_bytes())
    # a source built again with other defines (nerf_mlp_dgrad_wide.cu)
    for inc in re.findall(r'^#include "(\w+\.cu)"', src.read_text(), re.M):
        h.update((CSRC / inc).read_bytes())
    tag = "" if width is None else f"-w{int(width)}"
    return src, BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:12]}.so"


def build(name: str, width: Optional[int] = None) -> str:
    """Compiles csrc/<name>.cu (for the MLP width `width`, or without the
    flag) unless its current build exists.  Returns nvcc's wall time and
    output (register and shared-memory use); raises with the output if
    nvcc fails."""
    src, out = _target(name, width)
    if out.exists():
        return "(up to date)"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *_flags(width), "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)
    return f"nvcc wall time {time.perf_counter() - t0:.1f} s\n{log}"


def label(name: str, width: Optional[int] = None) -> str:
    return name if width is None else f"{name}@w{int(width)}"


def build_all(items) -> Dict[str, str]:
    """build() for each item (a name, or a (name, width) pair), the nvcc
    processes run side by side.  Returns {label: nvcc output}, the label a
    name or `<name>@w<width>`; raises with the first failure's output."""
    from concurrent.futures import ThreadPoolExecutor

    pairs = [(i, None) if isinstance(i, str) else (i[0], i[1]) for i in items]
    labels = [label(n, w) for n, w in pairs]
    with ThreadPoolExecutor(max_workers=max(1, len(pairs))) as pool:
        return dict(zip(labels, pool.map(lambda nw: build(*nw), pairs)))


def load(name: str, width: Optional[int] = None) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (at the MLP width `width`),
    built first if needed."""
    lib = _LIBS.get(label(name, width))
    if lib is None:
        build(name, width)
        lib = ctypes.CDLL(str(_target(name, width)[1]))
        _LIBS[label(name, width)] = lib
    return lib


def claim_device(index: int) -> None:
    """Records the card of this process's first launch and refuses any
    other: a library sets its kernels' shared-memory attributes once a
    process (function-scope statics), for the device current at its first
    launch, so a process drives one card (one process per card under
    torchrun or the coordinator flags)."""
    global _DEVICE
    if _DEVICE is None:
        _DEVICE = index
    elif index != _DEVICE:
        raise RuntimeError(f"lushnerf_torch kernels launch on one card a process (cuda:{_DEVICE}); "
                           f"got cuda:{index}: start one process per card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Builds csrc/ sources, side by side.")
    ap.add_argument("--json", default="", help="write {label: nvcc output} to this file")
    ap.add_argument("items", nargs="+", help="NAME or NAME@wWIDTH (an MLP source at a width)")
    args = ap.parse_args(argv)
    items = [(i.split("@w")[0], int(i.split("@w")[1])) if "@w" in i else i for i in args.items]
    logs = build_all(items)
    if args.json:
        Path(args.json).write_text(json.dumps(logs))
    for name, log in logs.items():
        print(f"{name}: {log.splitlines()[0] if log else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
