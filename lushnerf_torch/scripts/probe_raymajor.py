"""The per-ray primitives of a ray-major fused renderer, checked on one GPU.

    python -m lushnerf_torch.scripts.probe_raymajor

Runs the five probes of the JAX package's Mosaic probe
(`scripts/probe_raymajor_mosaic.py`) at its shapes and seeds, each through
its CUDA kernel (`lushnerf_torch/ops/fused/raymajor.py`), and holds the
result against a torch reference at the JAX probe's tolerance:
  P1, P1b  exclusive cumsum over S (T 16, S 64, c 8; seeds 0, 1), atol 1e-5
  P2       per-ray vector transpose [T*S, 1] -> [T, S] (seed 2), atol 1e-6
  P3       searchsorted count of cdf <= u (SI 64, seed 3), exact
  P4       boundary-masked dists z[k+1] - z[k] (seed 4), atol 1e-6
Each probe prints an [OK] or [FAIL] line; an exception is reported as
FAIL.  `main` returns [(name, ok)] for every probe.

`main(device="cuda")` raises without a card; `main(device="cpu")` runs the
plain versions.
"""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

from lushnerf_torch.ops.fused import raymajor


def _report(name, ok, extra=""):
    print(f"  [{'OK' if ok else 'FAIL'}] {name} {extra}", flush=True)
    return name, ok


def _probe(name, fn):
    try:
        return _report(name, bool(fn()))
    except Exception as e:  # a failed probe is reported; the others still run
        traceback.print_exc()
        return _report(name, False, repr(e)[:200])


def probe_excl_cumsum(dev, seed, T=16, S=64, c=8):
    x = torch.from_numpy(np.random.default_rng(seed).random((T * S, c), np.float32)).to(dev)
    out = raymajor.excl_cumsum(x, S)
    xr = x.reshape(T, S, c)
    ref = torch.cumsum(xr, dim=1) - xr
    return torch.allclose(out.reshape(T, S, c), ref, atol=1e-5)


def probe_transpose(dev, T=16, S=64):
    x = torch.from_numpy(np.random.default_rng(2).random((T * S, 1), np.float32)).to(dev)
    out = raymajor.ray_transpose(x, S)
    return out.shape == (T, S) and torch.allclose(out, x.reshape(T, S), atol=1e-6)


def probe_searchsorted(dev, T=16, S=64, SI=64):
    rng = np.random.default_rng(3)
    cdf = torch.from_numpy(np.sort(rng.random((T, S), np.float32), axis=1)).to(dev)
    u = torch.from_numpy(rng.random((T * SI, 1), np.float32)).to(dev)
    out = raymajor.searchsorted_count(cdf, u)
    ref = torch.sum((cdf[:, None, :] <= u.reshape(T, SI, 1)).float(), dim=2).reshape(T * SI, 1)
    return torch.equal(out, ref)


def probe_masked_dists(dev, T=16, S=64):
    z = np.sort(np.random.default_rng(4).random((T, S), np.float32), axis=1)
    z = torch.from_numpy(z.reshape(T * S, 1)).to(dev)
    out = raymajor.masked_dists(z, S)
    zz = z.reshape(T, S)
    ref = torch.cat([zz[:, 1:] - zz[:, :-1], torch.zeros((T, 1), device=dev)], 1).reshape(T * S, 1)
    return torch.allclose(out, ref, atol=1e-6)


def main(device: str = "cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_raymajor: no CUDA device; pass device='cpu' for the plain versions")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    print(f"device: {name}", flush=True)
    results = [
        _probe("P1 exclusive cumsum over samples", lambda: probe_excl_cumsum(dev, 0)),
        _probe("P1b exclusive cumsum over samples (seed 1)", lambda: probe_excl_cumsum(dev, 1)),
        _probe("P2 per-ray vector transpose", lambda: probe_transpose(dev)),
        _probe("P3 count searchsorted", lambda: probe_searchsorted(dev)),
        _probe("P4 boundary-masked dists", lambda: probe_masked_dists(dev)),
    ]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"{sum(ok for _, ok in results)}/{len(results)} primitives compile+verify on {name}",
          flush=True)
    return results


if __name__ == "__main__":
    sys.exit(0 if all(ok for _, ok in main()) else 1)
