"""What the f32 forward kernel's row scales cost: K1 f32 built with parts of
them compiled out, each timed on the same points.

    python -m lushnerf_torch.scripts.fwd_ablate [--P 655360] [--root CHECKOUT]

Builds csrc/nerf_mlp_fwd.cu of this checkout (or of the checkout at
`--root`, as it is only) with csrc/nerf_mlp_fwd_sm90.cuh as it is ("full"),
with each row's largest value not sought (every row at scale 1:
"no_row_max"), and with the warpgroup's vote on scaled rows at the end of
each layer replaced by a plain barrier ("no_vote": no layer rescales its
accumulator).  Both give the bits of "full" where every activation is
below 2^15, as the points here are.  Prints the card and, for each
variant, one JSON line: the median ms of K1 f32 output only and with the
stash over 5 windows of 10 back-to-back calls between CUDA events, and
whether its output and stash are the bits of "full".  Needs a card and
nvcc; the builds go to build/lushnerf_torch/fwd_ablate_*.so.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import nerf_mlp as fused

HEADER = "nerf_mlp_fwd_sm90.cuh"
# text of the header -> its replacement, per variant
PATCHES = {
    "no_row_max": [("    const float2 m = row_max(acc, relu);\n",
                    "    const float2 m = make_float2(0.f, 0.f);\n")],
    "no_vote": [("      any = named_bar_any(BAR_WG + wg, 128, dn.x < 1.f || dn.y < 1.f);\n",
                 "      named_bar(BAR_WG + wg, 128);\n")],
}


def _build(csrc: Path, variant: str) -> str:
    work = build.BUILD_DIR / f"fwd_ablate_{abs(hash(str(csrc))) % 10**8}_{variant}"
    work.mkdir(parents=True, exist_ok=True)
    header = (csrc / HEADER).read_text()
    for old, new in PATCHES.get(variant, []):
        if header.count(old) != 1:
            raise RuntimeError(f"fwd_ablate: {variant}: its text is not in {HEADER} once")
        header = header.replace(old, new)
    (work / HEADER).write_text(header)
    shutil.copy(csrc / "nerf_mlp_fwd.cu", work / "nerf_mlp_fwd.cu")
    out = work / "lib.so"
    # -fno-gnu-unique: each variant keeps its own statics (the launch's
    # once-set shared-memory attribute) when several are loaded in one process
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique",
                           f"-I{csrc}", "-o", str(out), str(work / "nerf_mlp_fwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}{proc.stderr}")
    return str(out)


def _ms(fn, n: int = 10, repeats: int = 5) -> float:
    fn()
    times = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def main(P: int = 655_360, root: str = "") -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("fwd_ablate: needs a card")
    csrc = Path(root) / "lushnerf_torch" / "csrc" if root else build.CSRC
    variants = ["full"] + ([] if root else list(PATCHES))
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda v: _build(csrc, v), variants)))
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(2)
    xd = torch.zeros((P, 8), device="cuda")
    xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
    d = torch.randn((P, 3), generator=gen, device="cuda")
    xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
    w, fp = fused.pack_params(mlp, "float32")
    geo = fused.pe_geometry(mlp.cfg)
    n_blocks = fused.fwd_grid(P, fused.sm_count(xd.device))
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((P, fused.OUT_CH), device="cuda")
    acts = torch.empty((P, fused.ACTS_LD), device="cuda")
    units = torch.empty((-(-P // fused.FWD_TILE), fused.UNIT_BLOCKS, fused.UNIT_WARPS),
                        device="cuda")
    rows, ref = [], None
    for variant, path in libs.items():
        lib = ctypes.CDLL(path)
        # the checkout's own entry: scale units since one version, the PE
        # geometry as (dx) rather than (kx, kd) since a later one
        with_units = hasattr(lib, "nerf_mlp_fwd_units")
        pe_args = [geo.dx] if hasattr(lib, "nerf_mlp_fwd_pe_lanes") else [geo.kx, geo.kd]
        n_ptr = 7 if with_units else 6
        lib.nerf_mlp_fwd.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (
            5 + len(pe_args)) + [ctypes.c_void_p]
        lib.nerf_mlp_fwd.restype = ctypes.c_int

        def call(stash: bool):
            ptrs = [xd.data_ptr(), w.data_ptr(), fp.data_ptr(), out.data_ptr(),
                    acts.data_ptr() if stash else None]
            if with_units:
                ptrs.append(units.data_ptr() if stash else None)
            rc = lib.nerf_mlp_fwd(*ptrs, None, P, *pe_args, 10, 4, 0, n_blocks, stream)
            if rc != 0:
                raise RuntimeError(f"fwd_ablate: {variant}: CUDA error {rc}")

        row = {"variant": variant, "source": str(csrc / HEADER), "P": P,
               "output_only_ms": _ms(lambda: call(False)), "stash_ms": _ms(lambda: call(True))}
        call(True)
        got = (out.clone(), acts.clone())
        ref = ref or got
        row["same_bits_as_full"] = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--P", type=int, default=655_360, help="points")
    ap.add_argument("--root", default="", help="the checkout whose kernel to build (default: this)")
    a = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    main(a.P, a.root)
