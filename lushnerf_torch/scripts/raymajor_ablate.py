"""What holds the vector cumsum (K6/K7) and the masked dists (K10) of
csrc/raymajor_probe.cu: each built with a part of its work compiled out,
and other checkouts' builds, timed in the same device windows beside
Tensor.clone of the same bytes and the launch floor.

    python -m lushnerf_torch.scripts.raymajor_ablate [--root CHECKOUT ...]

Builds csrc/raymajor_probe.cu of this checkout as it is ("full"), with
its loads replaced by values made from the index ("no_load"), without its
output stores ("no_store": a test keeps the values alive), and with the
scan (K6/K7) or the neighbour and the ray-end test (K10) removed, each
thread storing the floats it loaded ("no_scan"); and each `--root`
checkout's source as it is (the earlier argument lists, without
rays_per_block and index64, where the build has no `raymajor_abi`).  At
the renderer's shapes (5120 rays x 64 and x 128 samples, c = 1) and the
JAX probe's (16 x 64, the cumsum at c = 8) every build's two kernels
(this checkout's whole cumsum in groups of one warp and of the block, the
rest as the wrapper runs them), `Tensor.clone` of the same bytes (of z;
at c = 8 also of the cumsum's input) and the launch floor
(`Tensor.clone` of 16 bytes) take 21 windows each, in turns, of 50 calls
queued behind a device sleep.  Prints the card, then one JSON line a
shape: each one's median and quartiles in ms, and each whole build's
largest error against the plain versions.  Needs a card and nvcc; the
builds go to build/lushnerf_torch/raymajor_ablate_*.so.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import raymajor

# rays, samples and the cumsum's channels: the renderer's and the JAX probe's
SHAPES = {"coarse": (5120, 64, 1), "fine": (5120, 128, 1), "probe": (16, 64, 8)}
# variant -> [(text, replacement)], every text exactly once in the source;
# a text given as (begin, end) stands for the source from begin up to end
PATCHES = {
    "no_load": [
        ("      const float4 t = __ldg(reinterpret_cast<const float4*>(x) + q);\n",
         "      const float4 t = make_float4((float)f0, 1.f, 2.f, 3.f);\n"),
        ("  const float4 t = i < n4 ? __ldg(reinterpret_cast<const float4*>(z) + i)\n",
         "  const float4 t = i < n4 ? make_float4((float)f0, 1.f, 2.f, 3.f)\n"),
        ("  const float next_own = own ? __ldg(z + f0 + 4) : 0.f;\n",
         "  const float next_own = own ? (float)f0 : 0.f;\n"),
    ],
    "no_store": [
        ("        reinterpret_cast<float4*>(y)[q] = make_float4(out[0], out[1], out[2], out[3]);\n",
         "        if (out[0] + out[1] + out[2] + out[3] == 12345.f) y[q] = 1.f;  // keeps them\n"),
        ("    reinterpret_cast<float4*>(d)[i] = make_float4(o[0], o[1], o[2], o[3]);\n",
         "    if (o[0] + o[1] + o[2] + o[3] == 12345.f) d[i] = 1.f;  // keeps them\n"),
    ],
    "no_scan": [  # the thread's loop, the warp scan, the barrier and the warps' sums
        (("    // this thread's floats by channel", "    float out[F];\n"),
         "    const bool after[F] = {true, true, true, true};\n"
         "    const float loc[F] = {v[0], v[1], v[2], v[3]};\n"
         "    const bool first_row = true, e_starts = false;\n"
         "    const int seg = 0;\n"
         "    float e[CM] = {}, pre[CM] = {}, a[CM] = {};\n"),
        ("      o[k] = p == S - 1 ? 0.f : v[k + 1] - v[k];\n", "      o[k] = v[k];\n"),
    ],
}
VARIANTS = ("full", "no_load", "no_store", "no_scan")


def patched(src: str, variant: str) -> str:
    """The source with `variant`'s patches applied (raises unless each text
    is in it exactly once)."""
    for old, new in PATCHES.get(variant, []):
        begin, end = old if isinstance(old, tuple) else (old, "")
        if src.count(begin) != 1 or (end and src.count(end) != 1):
            raise RuntimeError(f"raymajor_ablate: {variant}: {begin.strip()!r} not once in the source")
        i = src.index(begin)
        j = src.index(end, i) if end else i + len(begin)
        src = src[:i] + new + src[j:]
    return src


def _build(csrc: Path, variant: str, tag: str) -> str:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"raymajor_ablate_{tag}_{variant}.cu"
    cu.write_text(patched((csrc / "raymajor_probe.cu").read_text(), variant))
    out = cu.with_suffix(".so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique",
                           "-o", str(out), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag} {variant}:\n{proc.stdout}{proc.stderr}")
    return str(out)


def _kernels(path: str, stream: int):
    """(cumsum(x, y, S, group), dists(z, d, S)) of the library at `path`,
    with the argument lists its build has (an earlier build ignores the
    group)."""
    lib = ctypes.CDLL(path)
    vp, ci, cl, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    current = hasattr(lib, "raymajor_abi")
    lib.raymajor_excl_cumsum.argtypes = (
        [vp, vp, ci, ci, ci] + ([ci, ci, cu, ci, ci] if current else []) + [vp])
    lib.raymajor_masked_dists.argtypes = [vp, vp, cl, ci] + ([cu, ci, ci] if current else []) + [vp]

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"raymajor_ablate: {path}: CUDA error {rc}")

    def cumsum(x, y, S, group):
        c = x.shape[1]
        extra = ((group, raymajor.cumsum_rays_per_block(S, c, group), *raymajor.divider(S * c), 0)
                 if current else ())
        check(lib.raymajor_excl_cumsum(x.data_ptr(), y.data_ptr(), x.shape[0] // S, S, c, *extra,
                                       stream))

    def dists(z, d, S):
        extra = (*raymajor.divider(S), 0) if current else ()
        check(lib.raymajor_masked_dists(z.data_ptr(), d.data_ptr(), z.numel(), S, *extra, stream))
    return current, cumsum, dists


def device_windows(fns: dict, n: int = 50, repeats: int = 21) -> dict:
    """Device ms per call of each function, `repeats` windows each taken in
    turns: n calls queued behind a device sleep longer than the host takes
    to enqueue them, timed with CUDA events from the end of the sleep."""
    cycles = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        cycles[name] = int(max(host_s, 1e-3) * 2 * 2e9)  # twice the host's time at <= 2 GHz
    times = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles[name])
            a.record()
            for _ in range(n):
                fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / n)
    return times


def main(roots=()) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("raymajor_ablate: needs a card")
    jobs = [(v, build.CSRC, v, "this") for v in VARIANTS]  # (name, csrc, variant, tag)
    jobs += [(f"root:{r}", Path(r) / "lushnerf_torch" / "csrc", "full", f"root{i}")
             for i, r in enumerate(roots)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda j: _build(*j[1:]), jobs))
    stream = torch.cuda.current_stream().cuda_stream
    builds = {j[0]: _kernels(path, stream) for j, path in zip(jobs, paths)}
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for label, (R, S, c) in SHAPES.items():
        n = R * S
        w = torch.rand((R, S, c), generator=gen, device="cuda") + 1e-3
        x = (w / w.sum(1, keepdim=True)).reshape(n, c)
        z = torch.sort(torch.rand((R, S), generator=gen, device="cuda"), -1).values.reshape(n, 1)
        y, d = torch.empty_like(x), torch.empty_like(z)
        tiny = torch.rand(4, generator=gen, device="cuda")
        fns, errs = {}, {}
        group = raymajor.cumsum_plan(S, c)[0]
        for name, (current, cumsum, dists) in builds.items():
            # this checkout's whole cumsum in either group; the rest in the wrapper's
            sweep = raymajor.CS_GROUPS if name == "full" else (group,)
            for g in sweep:
                tag = f"{name}_G{g}" if name == "full" else name
                fns[f"excl_cumsum/{tag}"] = lambda f=cumsum, g=g: f(x, y, S, g)
            fns[f"masked_dists/{name}"] = lambda f=dists: f(z, d, S)
            if not name.startswith("no_"):  # a whole kernel: its values
                for g in sweep if current else (0,):
                    y.fill_(float("nan"))
                    cumsum(x, y, S, g)
                    errs[f"{name}/excl_cumsum_G{g}"] = (
                        y - raymajor.excl_cumsum_plain(x, S)).abs().max().item()
                d.fill_(float("nan"))
                dists(z, d, S)
                errs[f"{name}/masked_dists"] = (
                    d - raymajor.masked_dists_plain(z, S)).abs().max().item()
        fns["clone"] = lambda: z.clone()
        if c > 1:
            fns["clone_cumsum_bytes"] = lambda: x.clone()
        fns["floor"] = lambda: tiny.clone()
        times = device_windows(fns)
        row = {"shape": label, "rays": R, "samples": S, "cumsum_channels": c, "max_abs_err": errs}
        for name, ms in times.items():
            q = np.percentile(ms, [25, 50, 75])
            row[name] = {"median": float(q[1]), "p25": float(q[0]), "p75": float(q[2])}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[],
                    help="another checkout whose kernels to time beside this one's (repeatable)")
    a = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    main(a.root)
