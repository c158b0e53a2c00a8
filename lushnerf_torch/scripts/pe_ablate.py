"""What holds the PE-only kernel (K4, `pe_only` in csrc/nerf_pe_mm.cu):
it built with parts of its work compiled out, each timed on the same
points.

    python -m lushnerf_torch.scripts.pe_ablate [--P 983040] [--root CHECKOUT] [--build_only]

Builds csrc/nerf_pe_mm.cu of this checkout (or of the checkout at
`--root`) as it is ("full"), with every trig lane's sinf replaced by its
argument ("no_trig": the issue slots of the range reductions and
polynomials gone, every load and store kept), and without the output
stores ("no_store": each thread's stores, or the tile's bulk copy,
replaced by a test that keeps the values alive).  The patches know two
versions of the kernel: one warp a point with four lanes a thread
(`pe_lane`, up to commit e0a20da) and the persistent tile kernel that
replaced it.  Prints the card and, for each variant, one JSON line:
its median ms over 5 windows of 20 back-to-back calls between CUDA events,
the byte bound (32 B read and 512 B written a point at 3.35 TB/s) and, for
"full", its largest error against `pe_only_plain`.  Needs a card and nvcc;
the builds go to build/lushnerf_torch/pe_ablate_<variant>_<digest>.so and
are reused while the patched source, the headers and the flags are the
same (`build_variants` compiles them ahead of a run).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from lushnerf_torch.ops.fused import build

PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# variant -> its (text, replacement) alternatives: the one-warp-a-point
# kernel's, then the tile kernel's; exactly one must be in the source
PATCHES = {
    "no_trig": [
        ("  return sinf(r < 3 ? a : a + HALF_PI_F);\n",
         "  return r < 3 ? a : a + HALF_PI_F;\n"),
        ("      row[0] = sinf(a);\n      row[3] = sinf(a + HALF_PI_F);\n",
         "      row[0] = a;\n      row[3] = a + HALF_PI_F;\n"),
    ],
    "no_store": [
        ("  reinterpret_cast<float4*>(out + p * LANES)[lane] = v;\n",
         "  if (v.x + v.y + v.z + v.w == 12345.f) out[p] = 1.f;  // keeps the values\n"),
        ("    if (t == 0) {\n      hopper::bulk_s2g(out + p0 * LANES, rows, n * LANES * 4);\n",
         "    if (rows[(t * 67 + tile) % (PE_T * LANES)] == 12345.f) {  // keeps the rows\n"),
    ],
}
VARIANTS = ("full", "no_trig", "no_store")


def patched(src: str, variant: str) -> str:
    """The source with `variant`'s patch applied (raises unless exactly one
    of its alternatives is in it, once)."""
    if variant == "full":
        return src
    hits = [(old, new) for old, new in PATCHES[variant] if src.count(old) == 1]
    if len(hits) != 1:
        raise RuntimeError(f"pe_ablate: {variant}: not one of its texts in nerf_pe_mm.cu")
    return src.replace(*hits[0])


def _build(csrc: Path, variant: str) -> str:
    """The variant's library, compiled unless a build of the same patched
    source, headers and flags exists."""
    src = patched((csrc / "nerf_pe_mm.cu").read_text(), variant)
    h = hashlib.sha1(src.encode() + " ".join(build.NVCC_FLAGS).encode())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = f"{variant}_{h.hexdigest()[:12]}"
    out = build.BUILD_DIR / f"pe_ablate_{tag}.so"
    if out.exists():
        return str(out)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"pe_ablate_{tag}.cu"
    cu.write_text(src)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", str(tmp), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def build_variants(root: str = "") -> dict:
    """{variant: library path} for this checkout's csrc/nerf_pe_mm.cu (or
    the one at `root`), the variants compiled side by side where needed."""
    csrc = Path(root) / "lushnerf_torch" / "csrc" if root else build.CSRC
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(lambda v: _build(csrc, v), VARIANTS)))


def _ms(fn, n: int = 20, repeats: int = 5) -> float:
    import numpy as np
    import torch

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


def main(P: int = 983_040, root: str = "") -> list:
    import numpy as np
    import torch

    from lushnerf_torch.ops.fused import pe_mm

    if not torch.cuda.is_available():
        raise RuntimeError("pe_ablate: needs a card")
    csrc = Path(root) / "lushnerf_torch" / "csrc" if root else build.CSRC
    libs = build_variants(root)
    xd = torch.from_numpy(np.random.default_rng(0).standard_normal((P, 8)).astype(np.float32)).cuda()
    out = torch.empty((P, pe_mm.LANES), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bound = P * (32 + 4 * pe_mm.LANES) / PEAK_BYTES * 1e3
    rows = []
    for variant, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.nerf_pe_only.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.nerf_pe_only.restype = ctypes.c_int

        def call():
            rc = lib.nerf_pe_only(xd.data_ptr(), out.data_ptr(), P, stream)
            if rc != 0:
                raise RuntimeError(f"pe_ablate: {variant}: CUDA error {rc}")

        row = {"variant": variant, "source": str(csrc / "nerf_pe_mm.cu"), "P": P, "ms": _ms(call),
               "bound_ms": bound, "bound_by": "bytes"}
        if variant == "full":
            call()
            row["max_abs_err"] = (out - pe_mm.pe_only_plain(xd)).abs().max().item()
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--P", type=int, default=983_040, help="points")
    ap.add_argument("--root", default="", help="the checkout whose kernel to build (default: this)")
    ap.add_argument("--build_only", action="store_true",
                    help="compile the variants (where needed) and time nothing: no card needed")
    a = ap.parse_args()
    if a.build_only:
        print(json.dumps(build_variants(a.root)), flush=True)
        raise SystemExit(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    main(a.P, a.root)
