#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (lushnerf_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, in order (any failure makes the exit code non-zero and suppresses
the final result line):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build: the fused NeRF-MLP kernel's CUDA source with nvcc for sm_90a;
  3. kernel: the fused NeRF-MLP kernel against its plain PyTorch version at
     width 256 / depth 8, at the flagship point counts 5120x64 and 5120x128
     (forward_kernel), 4096x64 and 4096x128 (a render_image chunk) and at
     a ragged count; median kernel and plain times from CUDA events.
     f32: rtol 1e-4, atol 1e-5.  bf16: rtol 1e-3, atol 1e-3 on each value
     (the same bf16 roundings, but sums in another order move some
     activations to the neighbouring bf16 value), and a mean error at most
     a tenth of the mean gap between the plain version in f32 and in bf16,
     so that a kernel that skipped the bf16 rounding would fail;
  4. forward_kernel: the flagship config (29 images, 1024 rays x 5
     sub-rays, 400x400, focal 320) -- finite outputs, exactly 2 kernel
     launches per call, agreement with the plain-torch backend on the
     same random draws, and the time per call of both backends;
  5. render_image: one 400x400 view at ray_chunk 4096 (40 chunks, 80
     launches), compared with and timed against the same render through
     mlp_backend='torch';
  6. profile: a torch.profiler trace of forward_kernel and render_image:
     device time by kernel and the device's busy share.
Then a `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.
It needs the repository checkout: run alone it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

H = W = 400
FOCAL = 320.0
N_RAYS = 1024
NUM_IMAGES = 29
RAY_CHUNK = 4096
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM f32, outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MLP_MACS = 593_408  # per point, unpadded scene MLP (PE excluded)
KERNEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}
BF16_MEAN_ERR_SHARE = 0.1  # of the plain version's mean f32-vs-bf16 gap


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median over `iters` runs of fn, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def wall_ms(fn, n: int) -> float:
    """Host-clock ms per call over n synchronised calls of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def bound_ms(P: int, w_bytes: int, bf16: bool) -> tuple:
    flops = 2.0 * MLP_MACS * P
    nbytes = P * (8 * 4 + 4 * 4) + w_bytes  # xd in, raw out, params once
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


class Smoke:
    def __init__(self):
        self.failed = []
        self.results = {}

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            self.results[name] = fn()
            print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        except Exception:  # a phase failure is reported, the others still run
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name}: FAILED", flush=True)


def sample_points(P: int, gen: torch.Generator) -> torch.Tensor:
    """Packed [P, 8] points in the NDC cube with unit view directions."""
    xd = torch.zeros((P, 8), device="cuda")
    xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
    d = torch.randn((P, 3), generator=gen, device="cuda")
    xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
    return xd


def kernel_phase(fused, NeRFMLP, MLPConfig):
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {"coarse": 5120 * 64, "fine": 5120 * 128, "render_coarse": 4096 * 64,
              "render_fine": 4096 * 128, "ragged": 4096 * 64 + 37}
    rows = []
    for dtype in ("float32", "bfloat16"):
        w_bytes = sum(t.numel() * t.element_size() for t in fused.pack_params(mlp, dtype))
        for label, P in shapes.items():
            xd = sample_points(P, gen)
            got = fused.nerf_mlp_fwd(mlp, xd, dtype)
            want = fused.nerf_mlp_fwd_plain(mlp, xd, dtype)
            torch.cuda.synchronize()
            err = (got - want).abs()
            tol = KERNEL_TOL[dtype]
            excess = (err - tol["atol"] - tol["rtol"] * want.abs()).max().item()
            row = dict(dtype=dtype, shape=label, P=P, max_abs_err=err.max().item(),
                       mean_abs_err=err.mean().item(),
                       finite=bool(torch.isfinite(got).all()), within_tol=excess <= 0)
            if dtype == "bfloat16":
                # the control: how far the plain version moves without bf16 rounding
                gap = (fused.nerf_mlp_fwd_plain(mlp, xd, "float32") - want).abs()
                row["plain_f32_vs_bf16_max_gap"] = gap.max().item()
                row["plain_f32_vs_bf16_mean_gap"] = gap.mean().item()
                row["within_tol"] &= (row["mean_abs_err"]
                                      <= BF16_MEAN_ERR_SHARE * row["plain_f32_vs_bf16_mean_gap"])
            if label != "ragged":
                row["ms"] = time_ms(lambda: fused.nerf_mlp_fwd(mlp, xd, dtype), 20)
                row["plain_ms"] = time_ms(lambda: fused.nerf_mlp_fwd_plain(mlp, xd, dtype), 5, 1)
                row["bound_ms"], row["bound_by"] = bound_ms(P, w_bytes, dtype == "bfloat16")
                row["tflops"] = 2.0 * MLP_MACS * P / row["ms"] / 1e9
            print("  " + json.dumps(row), flush=True)
            rows.append(row)
            if not (row["finite"] and row["within_tol"]):
                raise AssertionError(f"kernel disagrees with plain version: {row}")
    return rows


def flagship(cfg_mod, backend=None, dtype=None):
    lc = cfg_mod.flagship_cfg(num_images=NUM_IMAGES).lush_config()
    if backend is not None:
        lc = dataclasses.replace(
            lc, render=dataclasses.replace(lc.render, mlp_backend=backend, mlp_compute_dtype=dtype)
        )
    return lc


def flagship_batch():
    rng = np.random.default_rng(0)
    rays_o = (0.1 * rng.standard_normal((N_RAYS, 3))).astype(np.float32)
    rays_d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5
    rays = torch.from_numpy(np.stack([rays_o, rays_d], axis=-1)).cuda()
    idx = torch.from_numpy(rng.integers(0, NUM_IMAGES, N_RAYS)).cuda()
    return rays, idx


def max_err(a, b):
    return (a - b).abs().max().item()


def forward_phase(fused, lush, cfg_mod):
    lc = flagship(cfg_mod)
    model = lush.LushNeRF(lc, seed=0, device="cuda")
    rays, idx = flagship_batch()
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    with torch.no_grad():
        # the same draws through the kernel (bf16, f32) and plain torch (f32)
        rnd = lush._train_randomness(gen, lc, N_RAYS * lc.rbk.num_rays_out, rays.device)
        outs = {
            name: lush.forward_kernel(
                model, flagship(cfg_mod, be, dt), H, W, FOCAL, rays, idx, None,
                rand_override=rnd,
            )
            for name, be, dt in (("bf16", "cuda", "bfloat16"), ("f32", "cuda", "float32"),
                                 ("torch", "torch", "float32"))
        }
        for key in ("rgb_blur", "rgb0_blur", "depth", "acc"):
            res[f"{key}_err_f32_vs_torch"] = max_err(outs["f32"][key], outs["torch"][key])
            res[f"{key}_err_bf16_vs_torch"] = max_err(outs["bf16"][key], outs["torch"][key])
        lush.forward_kernel(model, lc, H, W, FOCAL, rays, idx, gen)  # warm-up
        torch.cuda.synchronize()
        n_calls = 5
        fused.launches = 0
        t0 = time.perf_counter()
        for _ in range(n_calls):
            out = lush.forward_kernel(model, lc, H, W, FOCAL, rays, idx, gen)
        torch.cuda.synchronize()
        res["ms_per_call"] = (time.perf_counter() - t0) * 1e3 / n_calls
        res["launches"] = fused.launches
        tcfg = flagship(cfg_mod, "torch", "float32")
        res["torch_f32_ms_per_call"] = wall_ms(
            lambda: lush.forward_kernel(model, tcfg, H, W, FOCAL, rays, idx, gen), n_calls)
    res["calls"] = n_calls
    res["rays_per_s"] = N_RAYS / res["ms_per_call"] * 1e3
    res["finite"] = all(bool(torch.isfinite(v).all()) for v in out.values())
    res["rgb_blur_shape"] = list(out["rgb_blur"].shape)
    print("  " + json.dumps(res), flush=True)
    assert res["launches"] == 2 * n_calls, f"expected {2 * n_calls} launches"
    assert res["finite"] and res["rgb_blur_shape"] == [N_RAYS, 3]
    for key in ("rgb_blur", "rgb0_blur", "acc"):
        assert res[f"{key}_err_f32_vs_torch"] < 1e-4, key
        assert res[f"{key}_err_bf16_vs_torch"] < 1e-2, key
    assert res["depth_err_f32_vs_torch"] < 1e-3 and res["depth_err_bf16_vs_torch"] < 5e-2
    return res


def render_phase(fused, lush, cfg_mod):
    lc = flagship(cfg_mod)
    model = lush.LushNeRF(lc, seed=0, device="cuda")
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    res = {}
    lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)  # warm-up
    torch.cuda.synchronize()
    fused.launches = 0
    t0 = time.perf_counter()
    rgb, noise, depth = lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK)
    torch.cuda.synchronize()
    res["ms_per_image"] = (time.perf_counter() - t0) * 1e3
    res["launches"] = fused.launches
    t0 = time.perf_counter()
    ref = lush.render_image(model, flagship(cfg_mod, "torch", "float32"), H, W, K, c2w,
                            RAY_CHUNK)
    torch.cuda.synchronize()
    res["torch_f32_ms_per_image"] = (time.perf_counter() - t0) * 1e3
    f32 = lush.render_image(model, flagship(cfg_mod, "cuda", "float32"), H, W, K, c2w,
                            RAY_CHUNK)
    for i, key in enumerate(("rgb", "noise", "depth")):
        res[f"{key}_err_bf16_vs_torch"] = max_err((rgb, noise, depth)[i], ref[i])
        res[f"{key}_err_f32_vs_torch"] = max_err(f32[i], ref[i])
    res["finite"] = all(bool(torch.isfinite(t).all()) for t in (rgb, noise, depth))
    res["shape"] = list(rgb.shape)
    print("  " + json.dumps(res), flush=True)
    assert res["launches"] == 80, "expected 80 launches (40 chunks x coarse + fine)"
    assert res["finite"] and res["shape"] == [H, W, 3]
    assert res["rgb_err_f32_vs_torch"] < 1e-4 and res["rgb_err_bf16_vs_torch"] < 1e-2
    assert res["depth_err_f32_vs_torch"] < 1e-3 and res["depth_err_bf16_vs_torch"] < 5e-2
    return res


def profile_phase(lush, cfg_mod):
    """Device time by kernel and the device's busy share (the union of
    kernel intervals over the span of the traced region), from
    torch.profiler, over 3 forward_kernel calls and over one render_image."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lc = flagship(cfg_mod)
    model = lush.LushNeRF(lc, seed=0, device="cuda")
    rays, idx = flagship_batch()
    gen = torch.Generator(device="cuda").manual_seed(1)
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    runs = {
        "forward_kernel_x3": lambda: [lush.forward_kernel(model, lc, H, W, FOCAL, rays, idx, gen)
                                      for _ in range(3)],
        "render_image": lambda: lush.render_image(model, lc, H, W, K, c2w, RAY_CHUNK),
    }
    res = {}
    for name, fn in runs.items():
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        evs = prof.events()
        dev = [e for e in evs if e.device_type == DeviceType.CUDA]
        if not dev:
            res[name] = "not measured: the profiler recorded no device events"
            continue
        span = max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)
        busy, end = 0.0, -1.0
        for e in sorted(dev, key=lambda e: e.time_range.start):
            s, t = e.time_range.start, e.time_range.end
            if t > end:
                busy += t - max(s, end)
                end = t
        by_name = {}
        for e in dev:
            key = "nerf_mlp_fwd_kernel" if "nerf_mlp_fwd_kernel" in e.name else e.name[:70]
            ms, n = by_name.get(key, (0.0, 0))
            by_name[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        res[name] = {
            "span_ms": span / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / span,
            "kernel_ms_total": sum(ms for ms, _ in by_name.values()),
            "top_kernels": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top],
        }
    print("  " + json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write all results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from lushnerf_torch import config as cfg_mod
        from lushnerf_torch.models import lushnerf as lush
        from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
        from lushnerf_torch.ops.fused import build
        from lushnerf_torch.ops.fused import nerf_mlp as fused
    except ImportError as e:
        print(f"chip_smoke: the lushnerf_torch package is not here ({e})", file=sys.stderr)
        return 2
    # the plain versions are the reference: full f32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    def do_build():
        log = build.build("nerf_mlp_fwd")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  nerf_mlp_fwd: {line.strip()}")
        return log

    smoke.phase("build", do_build)
    if "build" not in smoke.failed:
        smoke.phase("kernel", lambda: kernel_phase(fused, NeRFMLP, MLPConfig))
        smoke.phase("forward_kernel", lambda: forward_phase(fused, lush, cfg_mod))
        smoke.phase("render_image", lambda: render_phase(fused, lush, cfg_mod))
        smoke.phase("profile", lambda: profile_phase(lush, cfg_mod))

    kernels = []
    rows = smoke.results.get("kernel") or []
    fine = next((r for r in rows if r["dtype"] == "bfloat16" and r["shape"] == "fine"), None)
    launches = sum(smoke.results.get(p, {}).get("launches", 0)
                   for p in ("forward_kernel", "render_image"))
    if fine is not None:
        kernels.append({
            "name": "nerf_mlp_fwd",
            "route": "cuda",
            "source": "lushnerf_torch/csrc/nerf_mlp_fwd.cu",
            "replaces": "lushnerf_tpu/ops/fused/nerf_mlp.py:396",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": fine["ms"],
            "plain_ms": fine["plain_ms"],
            "bound_ms": fine["bound_ms"],
            "bound_by": fine["bound_by"],
            "library_ms": None,
            "shapes": [{k: r[k] for k in ("dtype", "P", "ms", "plain_ms", "bound_ms",
                                          "max_abs_err") if k in r} for r in rows],
        })
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "failed": smoke.failed, "results": smoke.results, "kernels": kernels},
                      f, indent=1, default=str)
    if smoke.failed:
        print(f"chip_smoke: FAILED phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
