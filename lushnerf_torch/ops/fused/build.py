"""Builds a CUDA source under `lushnerf_torch/csrc/` with nvcc and loads it
with ctypes.

`csrc/<name>.cu` becomes `build/lushnerf_torch/lib<name>-<digest>.so` at
the repository root, compiled for Hopper (`sm_90a`) at first use; the
digest covers the source, the shared `csrc/*.cuh` headers and the flags, so
an edited source is rebuilt.  `build_all` compiles several sources at once,
one nvcc process each.
The sources have a plain C interface and include no PyTorch header, so a
build takes seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "lushnerf_torch"
# --split-compile=0: the device code's optimisation runs on all host cores,
# as a source's kernel instantiations otherwise compile one by one
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
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


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers the sources include
        h.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compiles csrc/<name>.cu unless its current build exists.  Returns
    nvcc's wall time and output (register and shared-memory use); raises
    with the output if nvcc fails."""
    src, out = _target(name)
    if out.exists():
        return "(up to date)"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)
    return f"nvcc wall time {time.perf_counter() - t0:.1f} s\n{log}"


def build_all(names) -> Dict[str, str]:
    """build() for each name, the nvcc processes run side by side.  Returns
    {name: nvcc output}; raises with the first failure's output."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
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
