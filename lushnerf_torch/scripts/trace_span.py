"""What tracing the CPU ops does to a traced train step's span: the
flagship step in three forms (f32 remat at point_chunk 65,536, the shipped
scene configs' step; bf16 stash; plain torch f32), each traced by
torch.profiler with the CPU ops and the CUDA activity and with the CUDA
activity alone, in turns (with, without, without, with), beside the
untraced step's host ms.

    python -m lushnerf_torch.scripts.trace_span

A trace's span runs from its first event to its last one's end (the
first CPU op or, without them, the first CUDA runtime call); busy is the
union of the device's kernel intervals.  Prints the card and one JSON line
a trace: span and busy ms, busy share, events recorded and the seconds
`prof.events()` takes to read them.  Needs a card.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from lushnerf_torch import config as cfg_mod
from lushnerf_torch.models import lushnerf as lush
from lushnerf_torch.train import trainer

H = W = 400
FOCAL = 320.0
N_RAYS = 1024
NUM_IMAGES = 29
# form -> (mlp_backend, compute dtype, backward, point_chunk)
FORMS = {"remat_f32": ("cuda", "float32", "remat", 65_536),
         "stash_bf16": ("cuda", "bfloat16", "stash", 0),
         "torch_f32": ("torch", "float32", "remat", 0)}


def batch() -> dict:
    rng = np.random.default_rng(0)
    rays_o = (0.1 * rng.standard_normal((N_RAYS, 3))).astype(np.float32)
    rays_d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5
    b = {"rays": np.stack([rays_o, rays_d], axis=-1),
         "rgbs": rng.random((N_RAYS, 3), dtype=np.float32),
         "images_idx": rng.integers(0, NUM_IMAGES, N_RAYS, dtype=np.int32),
         "fq_mask": rng.integers(0, 2, N_RAYS).astype(bool)}
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def trace(fn, cpu_ops: bool) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu_ops + [ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    evs = prof.events()
    read_s = time.perf_counter() - t0
    dev = sorted((e for e in evs if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("Optimizer.")), key=lambda e: e.time_range.start)
    span = max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)
    busy, end = 0.0, -1.0
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        if t > end:
            busy += t - max(s, end)
            end = t
    return {"cpu_ops": cpu_ops, "span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / span, "events": len(evs), "read_s": read_s}


def main() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("trace_span: needs a card")
    b = batch()
    rows = []
    for form, (backend, dtype, bwd, chunk) in FORMS.items():
        cfg = cfg_mod.flagship_cfg(num_images=NUM_IMAGES)
        cfg.mlp_backend, cfg.mlp_compute_dtype, cfg.mlp_bwd, cfg.point_chunk = (
            backend, dtype, bwd, chunk)
        lc = cfg.lush_config()
        model = lush.LushNeRF(lc, seed=0, device="cuda")
        opt, sched = trainer.make_optimizer(cfg, model)
        gen = torch.Generator(device="cuda").manual_seed(1)

        def step():
            return trainer.train_step(model, opt, sched, lc, H, W, FOCAL, b, "kernel", gen)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) * 1e3 / 3
        for cpu_ops in (True, False, False, True):
            rows.append({"form": form, "untraced_ms": untraced, **trace(step, cpu_ops)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    main()
