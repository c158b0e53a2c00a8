"""Kernel cost of the fused NeRF-MLP forward, and its split into PE and
matmuls, on one GPU.

    python -m lushnerf_torch.scripts.tune_kernel

At P = 983,040 points (standard-normal xd, numpy seed 0) through a NeRF
MLP of depth 8 and width 256 (input_ch 63, views 27, torch seed 0) in
bfloat16, it times
  * the forward kernel, output only, and forward + backward (`NerfMLPFn`
    with bwd_mode 'remat' on sum(out**2): the forward and the remat
    backward kernels), with TF/s counted on the padded matmuls as the JAX
    package's tuning script counts them (3x for forward + backward);
  * the PE alone (`pe_only`) and the matmuls alone on its output
    (`mm_only`).
Each time is a two-length difference (n_long - n_short calls timed with
CUDA events, over the count), repeated 5 times: median [min, max].  The
port's kernels are compiled for a tile of 128 points, so the JAX script's
sweep over tiles is one row here, at that tile.

`main(device="cuda")` raises without a card; `main(device="cpu", P=...)`
runs the plain versions at a small P with the host clock.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.fused import nerf_mlp as fused
from lushnerf_torch.ops.fused import pe_mm

TILE = 128  # points per block of the forward, pe_only and mm_only kernels
# multiply-adds per point of the padded matmuls, as the JAX tuning script counts them
MACS = 128 * 256 * 2 + 256 * 256 * 8 + 256 * 128 * 2 + 128 * 128 * 2


def timed(fn, device, n_short=4, n_long=16, repeats=5):
    """Seconds per call of fn by two-length differencing, `repeats` times:
    (median, min, max).  On the card each length is timed with CUDA
    events; on the CPU with the host clock."""
    cuda = device.type == "cuda"

    def run(n):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return time.perf_counter() - t0

    run(2)
    ts = []
    for _ in range(repeats):
        t_s = run(n_short)
        t_l = run(n_long)
        ts.append(max(t_l - t_s, 1e-9) / (n_long - n_short))
    return float(np.median(ts)), float(min(ts)), float(max(ts))


def _ms(t) -> str:
    return f"{t[0] * 1e3:7.3f} ms [{t[1] * 1e3:.3f},{t[2] * 1e3:.3f}]"


def main(device: str = "cuda", P: int = 983040) -> dict:
    """Runs the measurements and prints one line each; returns
    {name: (median, min, max) seconds per call} with the device's name and P."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tune_kernel: no CUDA device; pass device='cpu' for the plain versions")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    print("device:", name)
    cd = "bfloat16"
    cfg = MLPConfig(depth=8, width=256, skips=(4,), use_viewdirs=True, input_ch=63,
                    input_ch_views=27)
    mlp = NeRFMLP(cfg, torch.Generator().manual_seed(0), torch.device("cpu")).to(dev)
    params = list(mlp.parameters())
    rng = np.random.default_rng(0)
    xd = torch.from_numpy(rng.standard_normal((P, fused.XD_CH)).astype(np.float32)).to(dev)
    fl = 2 * MACS * P

    def fwd():
        with torch.no_grad():
            return fused.nerf_mlp_fwd(mlp, xd, cd)

    def fwd_bwd():
        out = fused.NerfMLPFn.apply(mlp, xd, cd, 10, 4, "remat", 0, *params)
        return torch.autograd.grad(torch.sum(out * out), params)

    res = {"device": name, "P": P}
    res["fwd"] = timed(fwd, dev)
    res["fwd_bwd"] = timed(fwd_bwd, dev)
    print(f"tile={TILE:5d}  fwd {_ms(res['fwd'])} {fl / res['fwd'][0] / 1e12:6.1f} TF/s"
          f"   fwd+bwd {_ms(res['fwd_bwd'])} {3 * fl / res['fwd_bwd'][0] / 1e12:6.1f} TF/s(3x)"
          f"   (the kernels' compiled tile; no sweep)", flush=True)

    # --- PE-only and matmul-only kernels at the same tile --------------------
    pe = pe_mm.pe_only(xd)
    res["pe_only"] = timed(lambda: pe_mm.pe_only(xd), dev)
    res["mm_only"] = timed(lambda: pe_mm.mm_only(mlp, pe), dev)
    print(f"tile={TILE}: PE-only {_ms(res['pe_only'])}   matmul-only {_ms(res['mm_only'])} "
          f"({fl / res['mm_only'][0] / 1e12:.1f} TF/s)", flush=True)
    return res


if __name__ == "__main__":
    main()
