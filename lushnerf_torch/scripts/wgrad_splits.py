"""The bf16 wgrad's time by point-split count, on the same dgrad scratch.

    python -m lushnerf_torch.scripts.wgrad_splits [--P 327680 655360] [--most 11 22 33 66 132]

For each P: the forward kernel's stash and the bf16 stash backward's dgrad
on random points and g ~ N(0, 1) (CUDA seed 2), then the wgrad with its
reductions at each split count (`nerf_mlp.bf16_splits_of(P, most)`),
timed with CUDA events (median of 7), its weight grads held against those
of the default count (max |error| over max |value| of the whole weight
grad: only the order of the f32 sums differs).  Prints the card and one
JSON line per count.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.fused import nerf_mlp as fused


def _ms(fn, iters: int = 7) -> float:
    fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(points=(327_680, 655_360), most=(11, 22, 33, 66, 132)) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("wgrad_splits: needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for P in points:
        xd = torch.zeros((P, 8), device="cuda")
        xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
        d = torch.randn((P, 3), generator=gen, device="cuda")
        xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
        g = torch.randn((P, 4), generator=gen, device="cuda")
        acts = fused._launch_fwd(mlp, xd, "bfloat16", 10, 4, stash=True)[1]
        run = fused.BwdLaunch(mlp, xd, g, "bfloat16", 10, 4, acts)
        run.run()
        ref = run.dw.clone()
        for m in most:
            run.splits = [fused.bf16_splits_of(P, m)]
            run.w_part = torch.empty((run.n_splits, ref.numel()), dtype=torch.float32,
                                     device="cuda")
            ms = _ms(lambda: run.run(run.WGRAD))
            err = ((run.dw - ref).abs().max() / ref.abs().max()).item()
            row = {"P": P, "most": m, "n_splits": run.n_splits,
                   "pts_per_split": fused.wgrad_pts_per_split(P, run.n_splits, "bfloat16"),
                   "units_per_cluster": 12 * run.n_splits / (fused.sm_count(run.dev) // 2),
                   "wgrad_ms": ms, "partials_mb": run.w_part.numel() * 4 / 1e6,
                   "max_rel_err_vs_default": err}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del run, acts
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--P", type=int, nargs="+", default=[327_680, 655_360], help="points")
    ap.add_argument("--most", type=int, nargs="+", default=[11, 22, 33, 66, 132],
                    help="split counts to try (at most)")
    a = ap.parse_args()
    main(a.P, a.most)
