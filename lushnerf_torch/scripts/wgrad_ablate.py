"""Where the f32 wgrad's time goes: it built with parts of its work compiled
out, each timed on the same dgrad scratch.

    python -m lushnerf_torch.scripts.wgrad_ablate [--P 655360]

Builds csrc/nerf_mlp_bwd.cu as it is ("full") and with one or two parts
removed from its f32 wgrad -- the matmuls ("no_mma"), the converters'
global loads ("no_load": they split made-up values), the split and the
shared-memory stores ("no_split": the loads are kept alive by a sum) -- and
prints, for each, one JSON line: its CUDA-event ms (median of 5, with its
reductions) and block 0's cycle shares (nerf_mlp.WGRAD_F32_CLOCKS).  Only
"full" computes the weight grads; the others time a part of the work.
Needs a card and nvcc; the builds go to build/lushnerf_torch/ablate_*.so.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import nerf_mlp as fused

# text of csrc/nerf_mlp_bwd.cu -> its replacement, per removed part
_MMA = """      mma_mn<N>(acc, zh, ah);
      mma_mn<N>(acc, zl, ah);
      mma_mn<N>(acc, zh, al);
"""
_LOADS = ["""      zv[i][0] = ok ? __ldg(src) : zero;
      zv[i][1] = ok ? __ldg(src + 1) : zero;
""", """      av[i][0] = ok ? __ldg(src) : zero;
      av[i][1] = ok ? __ldg(src + 1) : zero;
"""]
_SPLIT = """#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      const int q = u + NCONV * i;
      put_parts(base + S_ZH, base + S_ZL, q >> 4, (q & 15) * 8, zv[i], up);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int q = u + NCONV * i;
      put_parts(base + S_AH, base + S_AL, q / (N / 8), (q % (N / 8)) * 8, av[i], 1.f);
    }
"""
PATCHES = {
    "no_mma": [(_MMA, "")],
    "no_load": [(t, t.replace("ok ? __ldg(src) : zero", "make_float4(u, i, k, c)")
                 .replace("ok ? __ldg(src + 1) : zero", "make_float4(c, k, i, u)")) for t in _LOADS],
    "no_split": [(_SPLIT, """    float sum = 0.f;
    for (int i = 0; i < NZ; ++i) sum += zv[i][0].x + zv[i][1].w;
    for (int i = 0; i < NA; ++i) sum += av[i][0].x + av[i][1].w;
    if (sum == 12345.f) wf32(SM_RED)[7] = sum;  // keeps the loads
""")],
}
VARIANTS = {"full": [], "no_mma": ["no_mma"], "no_load": ["no_load"], "no_split": ["no_split"],
            "loads_only": ["no_mma", "no_split"], "split_only": ["no_mma", "no_load"],
            "mma_only": ["no_load", "no_split"]}


def _build(name: str) -> str:
    src = (build.CSRC / "nerf_mlp_bwd.cu").read_text()
    for part in VARIANTS[name]:
        for old, new in PATCHES[part]:
            if old not in src:
                raise RuntimeError(f"wgrad_ablate: {part}: its text is not in nerf_mlp_bwd.cu")
            src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"ablate_{name}.cu"
    cu.write_text(src)
    out = build.BUILD_DIR / f"ablate_{name}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(out),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return str(out)


def _ms(fn, iters: int = 5) -> float:
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


def main(P: int = 655_360) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("wgrad_ablate: needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(_build, VARIANTS)))
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(2)
    xd = torch.zeros((P, 8), device="cuda")
    xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
    d = torch.randn((P, 3), generator=gen, device="cuda")
    xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
    g = torch.randn((P, 4), generator=gen, device="cuda")
    acts = fused._launch_fwd(mlp, xd, "float32", 10, 4, stash=True)[1]
    run = fused.BwdLaunch(mlp, xd, g, "float32", 10, 4, acts)
    run.run()
    argtypes = run.lib.nerf_mlp_bwd.argtypes
    rows = []
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.nerf_mlp_bwd.argtypes, lib.nerf_mlp_bwd.restype = argtypes, ctypes.c_int
        run.lib = lib
        ms = _ms(lambda: run.run(run.WGRAD))
        c = dict(zip(fused.WGRAD_F32_CLOCKS, run.wgrad_clocks().cpu().tolist()))
        row = {"variant": name, "P": P, "ms": ms,
               "consumer_share": {k: c[k] / c["mm_all"] for k in ("mm_full_wait", "mm", "mm_epilogue")},
               "converter_share": {k: c[k] / c["conv_all"] for k in (
                   "conv_load_issue", "conv_empty_wait", "conv_scale", "conv_work")}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--P", type=int, default=655_360, help="points")
    main(ap.parse_args().P)
