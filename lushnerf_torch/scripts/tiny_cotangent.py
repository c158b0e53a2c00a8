"""The f32 backward (K3 at P = 327,680) on cotangents far below the shipped
step's, to hold two checkouts against each other.

    python lushnerf_torch/scripts/tiny_cotangent.py [--root CHECKOUT]

Imports lushnerf_torch from CHECKOUT (default: the checkout this file is in)
and runs the remat backward in f32 on the flagship MLP at g with half the
points 0 and the rest |g| log-uniform over 2^lo .. 2^-60 with random signs,
for lo in -149 (f32's least denormal), -120, -100 and -80; prints one JSON
line per lo: whether d(xd) is finite and which of the 24 grads are not.
The f32 dgrad scales each d_z row by a power of two chosen layer by layer;
where a row needs more than 2^100 in all, a dgrad that does not hold the
whole scale within 2^+-100 returns NaN.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

P = 327_680
LOWEST = (-149, -120, -100, -80)


def main(root: str) -> list:
    sys.path.insert(0, root)
    import torch

    from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
    from lushnerf_torch.ops.fused import nerf_mlp as fused

    if not torch.cuda.is_available():
        raise RuntimeError("tiny_cotangent: needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    xd = torch.zeros((P, 8), device="cuda")
    xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
    d = torch.randn((P, 3), generator=gen, device="cuda")
    xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
    rows = []
    for lo in LOWEST:
        mag = torch.exp2(torch.rand((P, 4), generator=gen, device="cuda") * (-60 - lo) + lo)
        sign = torch.where(torch.rand((P, 4), generator=gen, device="cuda") < 0.5, -1.0, 1.0)
        g = mag * sign * (torch.rand((P, 1), generator=gen, device="cuda") < 0.5)
        d_xd, grads = fused.nerf_mlp_bwd(mlp, xd, g, "float32")
        torch.cuda.synchronize()
        row = {"root": root, "g_lowest_log2": lo, "g_highest_log2": -60,
               "dxd_finite": bool(torch.isfinite(d_xd).all()),
               "nonfinite_grads": [i for i, t in enumerate(grads) if not torch.isfinite(t).all()]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose lushnerf_torch to run")
    main(ap.parse_args().root)
