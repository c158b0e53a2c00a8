"""Digests of the backward kernels' outputs on fixed inputs, to hold two
checkouts against each other bit for bit.

    python lushnerf_torch/scripts/bwd_digest.py [--root CHECKOUT]

Imports lushnerf_torch from CHECKOUT (default: the checkout this file is in),
runs the forward kernel with its stash and the stash backward at P =
65,573 (a ragged tile count), f32 and bf16, at g ~ N(0, 1) and at a
cotangent shaped like the shipped configs' step (half the points 0, |g|
log-uniform over 2^-28..2^-17), and prints one JSON line per case: the
SHA-256 (16 hex digits) of d(xd), of the dz and PE scratch the dgrad
writes, of the bias and head grads (the dgrad's partials, reduced) and of
the weight grads.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

P = 65_536 + 37


def main(root: str) -> list:
    sys.path.insert(0, root)
    import torch

    from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
    from lushnerf_torch.ops.fused import nerf_mlp as fused

    if not torch.cuda.is_available():
        raise RuntimeError("bwd_digest: needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False

    def digest(t):
        raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
        return hashlib.sha256(raw).hexdigest()[:16]

    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(7)
    xd = torch.zeros((P, 8), device="cuda")
    xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
    d = torch.randn((P, 3), generator=gen, device="cuda")
    xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
    normal = torch.randn((P, 4), generator=gen, device="cuda")
    mag = torch.exp2(torch.rand((P, 4), generator=gen, device="cuda") * 11 - 28)
    sign = torch.where(torch.rand((P, 4), generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    shipped = mag * sign * (torch.rand((P, 1), generator=gen, device="cuda") < 0.5)
    rows = []
    for dtype in ("float32", "bfloat16"):
        acts = fused._launch_fwd(mlp, xd, dtype, 10, 4, stash=True)[1]
        for name, g in (("normal", normal), ("shipped", shipped)):
            run = fused.BwdLaunch(mlp, xd, g, dtype, 10, 4, acts)
            run.run()
            torch.cuda.synchronize()
            row = {"root": root, "dtype": dtype, "g": name, "dxd": digest(run.dxd),
                   "dz": digest(run.dz), "pe": digest(run.pe), "dfp": digest(run.dfp),
                   "dw": digest(run.dw)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose lushnerf_torch to run")
    main(ap.parse_args().root)
