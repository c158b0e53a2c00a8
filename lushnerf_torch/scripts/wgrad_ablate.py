"""Where a wgrad's time goes: it built with parts of its work compiled out
or changed, each timed on the same dgrad scratch.

    python -m lushnerf_torch.scripts.wgrad_ablate [--P 655360] [--dtype float32]

Builds csrc/nerf_mlp_bwd.cu as it is ("full") and with parts of one
wgrad's work removed or changed.  The f32 wgrad: the matmuls ("no_mma"),
the converters' global loads ("no_load": they split made-up values), the
split and the shared-memory stores ("no_split": the loads are kept alive by
a sum).  The bf16 wgrad: the matmuls ("no_mma"), the TMA loads ("no_load":
the matmuls read stale stages), and the multicast of A ("own_a": each
block of a cluster loads all of A itself, as if the two o-halves of a
weight block did not share it).  Prints, for each, one JSON line: its
CUDA-event ms (median of 5, with its reductions), block 0's cycle shares
(the dtype's `wgrad_clock_names`), and whether its weight grads are the
bits of "full" ("full" and "own_a" compute them; the others time a part
of the work).  Needs a card and nvcc; the builds go to
build/lushnerf_torch/ablate_*.so.
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
    if (ea == 0) {  // (the warp group takes the branch as one: no multiply on ordinary input)
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int q = u + NCONV * i;
        put_parts(base + S_AH, base + S_AL, q / (N / 8), (q % (N / 8)) * 8, av[i], 1.f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int q = u + NCONV * i;
        put_parts(base + S_AH, base + S_AL, q / (N / 8), (q % (N / 8)) * 8, av[i], aup);
      }
    }
"""
# the bf16 wgrad's matmuls and its producer's loads of a stage
_B_MMA = """      mma_mn<N>(acc, wgmma_desc_mn(base + S_Z + zb * BOX_B + off, BOX_B, ATOM),
                wgmma_desc_mn(base + S_A + off, BOX_B, ATOM));
"""
_B_LOADS = """      mbar_arrive_expect_tx(full, (nz + nb) * BOX_B);
      for (int b = 0; b < nz; ++b)
        tma_load_2d(base + S_Z + b * BOX_B, tm_dz, z_col + 64 * b, p0, full);
      for (int b = rank; b < nb; b += CLUSTER)
        tma_load_2d_multicast(base + S_A + b * BOX_B, tm_a, t.a_col + 64 * b, p0, full, 3);
"""
_B_OWN_A = """      for (int b = 0; b < nb; ++b)
        tma_load_2d(base + S_A + b * BOX_B, tm_a, t.a_col + 64 * b, p0, full);
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
    "bf16_no_mma": [(_B_MMA, "")],
    "bf16_no_load": [(_B_LOADS, "      mbar_arrive(full);\n")],
    "bf16_own_a": [(_B_LOADS.split("\n", 3)[3], _B_OWN_A)],
}
VARIANTS = {
    "float32": {"full": [], "no_mma": ["no_mma"], "no_load": ["no_load"], "no_split": ["no_split"],
                "loads_only": ["no_mma", "no_split"], "split_only": ["no_mma", "no_load"],
                "mma_only": ["no_load", "no_split"]},
    "bfloat16": {"full": [], "no_mma": ["bf16_no_mma"], "no_load": ["bf16_no_load"],
                 "own_a": ["bf16_own_a"]},
}


def _build(dtype: str, name: str) -> str:
    src = (build.CSRC / "nerf_mlp_bwd.cu").read_text()
    for part in VARIANTS[dtype][name]:
        for old, new in PATCHES[part]:
            if old not in src:
                raise RuntimeError(f"wgrad_ablate: {part}: its text is not in nerf_mlp_bwd.cu")
            src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"ablate_{dtype}_{name}.cu"
    cu.write_text(src)
    out = build.BUILD_DIR / f"ablate_{dtype}_{name}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(out),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return str(out), (proc.stdout + proc.stderr).count("(C7518)")


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


def main(P: int = 655_360, dtype: str = "float32") -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("wgrad_ablate: needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = list(VARIANTS[dtype])
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: _build(dtype, n), names)))
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp = mlp.cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(2)
    xd = torch.zeros((P, 8), device="cuda")
    xd[:, :3] = torch.rand((P, 3), generator=gen, device="cuda") * 2 - 1
    d = torch.randn((P, 3), generator=gen, device="cuda")
    xd[:, 3:6] = d / d.norm(dim=-1, keepdim=True)
    g = torch.randn((P, 4), generator=gen, device="cuda")
    acts = fused._launch_fwd(mlp, xd, dtype, 10, 4, stash=True)[1]
    run = fused.BwdLaunch(mlp, xd, g, dtype, 10, 4, acts)
    run.run()
    full = run.dw.clone()
    entries = ("nerf_mlp_bwd_wgrad", "nerf_mlp_bwd_reduce_all", "nerf_mlp_bwd_error_string")
    types = {e: (getattr(run.lib, e).argtypes, getattr(run.lib, e).restype) for e in entries}
    rows = []
    for name, (path, serialised) in libs.items():
        lib = ctypes.CDLL(path)
        for e in entries:
            getattr(lib, e).argtypes, getattr(lib, e).restype = types[e]
        run.lib = lib
        ms = _ms(lambda: run.run(run.WGRAD))
        c = dict(zip(run.wgrad_clock_names, run.wgrad_clocks().cpu().tolist()))
        loader = "conv_all" if "conv_all" in c else "load_all"
        row = {"variant": name, "dtype": dtype, "P": P, "ms": ms,
               "same_bits_as_full": torch.equal(run.dw, full),
               "ptxas_wgmma_serialised_notes": serialised,
               "consumer_share": {k: c[k] / c["mm_all"] for k in ("mm_full_wait", "mm", "mm_epilogue")},
               "loader_share": {k: v / c[loader] for k, v in c.items()
                                if k.startswith(loader[:4]) and k != loader}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--P", type=int, default=655_360, help="points")
    ap.add_argument("--dtype", default="float32", choices=sorted(VARIANTS))
    a = ap.parse_args()
    main(a.P, a.dtype)
