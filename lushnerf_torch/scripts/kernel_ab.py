"""Times the width-256 kernels of one or more checkouts in turns on one
card, beside `bwd_digest.py`'s digests of each, to hold a change against
its parent: same bits, times within the spread of the rounds.

    python lushnerf_torch/scripts/kernel_ab.py --roots PARENT . . PARENT

Each root in the list runs in a process of its own, in the order given
(parent, change, change, parent puts each side's two runs around the
other's), importing lushnerf_torch from that checkout (its kernels built
into its own build directory).  A run times, at P = 327,680 and 655,360
(the flagship step's coarse and fine MLPs) on the seed-0 flagship MLP, in
both compute dtypes: K1 output only and with its stash,
the dgrad and the wgrad with its reductions apart (`BwdLaunch.run` with
DGRAD / WGRAD on one chunk), K2 (the stash backward) and K3 (the remat
backward) whole, each the median of CUDA-event times of 10 calls after 3;
then prints the digests of this checkout's `bwd_digest.py` run on that
checkout's package (both widths, both dtypes).  Prints one JSON line a
run and, last, each kernel's times by root.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

PS = (5120 * 64, 5120 * 128)
REPS, WARMUP = 10, 3


def one(root: str) -> dict:
    """The times and digests of the checkout at `root` (run in a process of
    its own)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
    from lushnerf_torch.ops.fused import nerf_mlp as fused

    torch.backends.cuda.matmul.allow_tf32 = False

    def ms(fn) -> float:
        for _ in range(WARMUP):
            fn()
        out = []
        for _ in range(REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return float(np.median(out))

    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(7)
    times = {}
    for P in PS:
        xd = torch.zeros((P, 8), device="cuda")
        xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
        d = torch.randn((P, 3), generator=gen, device="cuda")
        xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
        g = torch.randn((P, 4), generator=gen, device="cuda")
        times[P] = {}
        for dt in ("float32", "bfloat16"):
            tag = "f32" if dt == "float32" else "bf16"
            _, acts, units = fused._launch_fwd(mlp, xd, dt, 10, 4, stash=True)
            run = fused.BwdLaunch(mlp, xd, g, dt, 10, 4, acts, units)
            run.run()
            times[P].update({
                f"k1_{tag}_ms": ms(lambda: fused._launch_fwd(mlp, xd, dt, 10, 4, stash=False)),
                f"k1_{tag}_stash_ms": ms(lambda: fused._launch_fwd(mlp, xd, dt, 10, 4,
                                                                   stash=True)),
                f"dgrad_{tag}_ms": ms(lambda: run.run(run.DGRAD)),
                f"wgrad_{tag}_ms": ms(lambda: run.run(run.WGRAD)),
                f"k2_{tag}_ms": ms(lambda: fused.nerf_mlp_bwd(mlp, xd, g, dt, 10, 4, acts=acts,
                                                              acts_units=units)),
                f"k3_{tag}_ms": ms(lambda: fused.nerf_mlp_bwd(mlp, xd, g, dt, 10, 4)),
            })
            del run, acts, units
            torch.cuda.empty_cache()
    # this checkout's digests (both widths) on the root's package
    spec = importlib.util.spec_from_file_location("bwd_digest",
                                                  Path(__file__).with_name("bwd_digest.py"))
    bwd_digest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bwd_digest)
    return {"root": root, "times": times, "digests": bwd_digest.main(root)}


def main(roots) -> list:
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve())],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_ab: the run of {root} failed:\n{proc.stdout}\n{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["root"] = root
        print(json.dumps(row), flush=True)
        runs.append(row)
    by_root = {}
    for r in runs:
        for P, t in r["times"].items():
            for k, v in t.items():
                by_root.setdefault(f"{k}@{P}", {}).setdefault(r["root"], []).append(v)
    digests = {r["root"]: [{k: v for k, v in d.items() if k != "root"} for d in r["digests"]]
               for r in runs}
    same = all(d == next(iter(digests.values())) for d in digests.values())
    print(json.dumps({"times_by_root": by_root, "digests_equal": same}), flush=True)
    return runs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[], help="checkouts, in the order to run")
    ap.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
    else:
        main(args.roots)
