"""The render driver: full-size views of the scene's poses in turn, through
`lushnerf_torch.models.lushnerf.render_image` (what `Trainer.render_pose`,
`eval_testset` and `render_only` call), each view's rgb brought to the host
in float32 (as eval's metrics read it; PNG encoding is left out).

Set-up builds the model from the configuration, puts the benchmark's
weights into it and renders one view (every shape the window uses).  The
window renders views until `--seconds` have passed; render_rays_per_s is
the pixels of the views completed over that time.  After the window one
view drawn from the seed among those rendered is compared, every pixel,
with the reference's render of its pose.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import program, work
from perfbench.harness import Check, Context, sync
from perfbench.reference import nerf as ref_nerf
from perfbench.reference.precision import float32_products, linear_fn
from perfbench.scene import intrinsics, make_scene


class Driver:
    unit = "view"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.c = ctx.config["config"]
        self.tr = ctx.traffic
        self.seeds = program.seeds(ctx.seed, "scene", "weights", "sample")
        self.spans: List[tuple] = []
        self.views: List[tuple] = []  # (pose index, rgb on the host)

    def setup(self):
        from lushnerf_torch.models import lushnerf as lush

        s = self.ctx.config["scene"]
        self.H, self.W = s["height"], s["width"]
        self.scene = make_scene(self.seeds["scene"], s["views"], self.H, self.W, s["focal"],
                                with_images=False)
        self.K = intrinsics(self.H, self.W, s["focal"])
        cfg = program.make_config(self.ctx.config, num_images=s["views"])
        self.lc = cfg.lush_config()
        self.chunk = cfg.ray_chunk_eval
        self.model = lush.LushNeRF(self.lc, seed=self.seeds["weights"], device=self.ctx.device)
        from perfbench.weights import make_weights

        self.weights = make_weights(program.named_shapes(self.model), self.seeds["weights"],
                                    self.ctx.device)
        program.load_weights(self.model, self.weights)
        self.lush = lush
        self._render(0)

    def _render(self, v: int) -> np.ndarray:
        a = time.perf_counter_ns()
        rgb, _, _ = self.lush.render_image(self.model, self.lc, self.H, self.W, self.K,
                                           self.scene["poses"][v], ray_chunk=self.chunk)
        b = time.perf_counter_ns()
        host = rgb.cpu().numpy()
        self.spans.append(("render_image", a, b))
        self.spans.append(("to_host", b, time.perf_counter_ns()))
        return host

    def window(self, seconds: float) -> dict:
        dev = self.ctx.device
        n_poses = len(self.scene["poses"])
        del self.spans[:]
        program.zero_launches()
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            v = len(self.views) % n_poses
            self.views.append((v, self._render(v)))
        elapsed = time.perf_counter() - t0
        spans_s: Dict[str, float] = {}
        for name, a, b in self.spans:
            spans_s[name] = spans_s.get(name, 0.0) + (b - a) / 1e9
        failed = sum(not np.isfinite(rgb).all() for _, rgb in self.views)
        parts = [(b - a) / 1e6 for n, a, b in self.spans if n == "render_image"]
        return {"units": len(self.views), "seconds": elapsed, "failed": int(failed),
                "parts_ms": parts,
                "spans_s": spans_s, "launches": program.read_launches(),
                "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}

    def traced_slice(self):
        from perfbench import devtrace

        del self.spans[:]
        n = self.tr["trace_views"]

        def run():
            for v in range(n):
                self._render(v % len(self.scene["poses"]))
            return n

        return devtrace.trace(run, self.spans)

    def end_to_end(self, win: dict) -> dict:
        return {"render_rays_per_s": self.H * self.W * win["units"] / win["seconds"]}

    def work(self) -> dict:
        c = self.c
        pts = work.view_points(self.H, self.W, c["N_samples"], c["N_importance"])
        fwd = pts * work.flop_per_point(c["netwidth"], c["multires"], c["multires_views"])
        n_params = work.mlp_params(c["netwidth"], work.pe_channels(c["multires"]),
                                   work.pe_channels(c["multires_views"]))
        return {"fwd_flop": fwd, "bwd_flop": 0.0, "model_flop": fwd,
                "fwd_bytes": work.fwd_bytes(pts, 2 * n_params), "bwd_bytes": 0.0}

    def release(self):
        self.model = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, win: dict) -> int:
        """The rendered view the check compares, drawn from the seed."""
        rng = np.random.default_rng(self.seeds["sample"])
        return int(rng.integers(len(self.views)))

    def reference(self, v: int, precision: str = "f32") -> torch.Tensor:
        dev = self.ctx.device
        pix = torch.arange(self.H * self.W, device=dev)
        lin = linear_fn(precision)
        with float32_products():
            rgb = ref_nerf.render_pixels(self.weights, self.c, self.H, self.W,
                                         torch.as_tensor(self.K, device=dev),
                                         torch.as_tensor(self.scene["poses"][v], device=dev),
                                         pix, lin, chunk=self.chunk)
        return rgb.reshape(self.H, self.W, 3)

    def check(self, win: dict) -> List[Check]:
        pose, rgb = self.views[self.sample(win)]
        ref = self.reference(pose)
        return self.compare(torch.as_tensor(rgb, device=ref.device), ref)

    def compare(self, rgb: torch.Tensor, ref: torch.Tensor) -> List[Check]:
        lim = self.ctx.limits
        gap = (rgb.float() - ref).abs()
        finite = bool(torch.isfinite(rgb).all())
        max_gap = float(gap.max()) if finite else float("inf")
        mean_gap = float(gap.mean()) if finite else float("inf")
        return [Check("rgb_max_gap", max_gap, lim["rgb_max_gap"]),
                Check("rgb_mean_gap", mean_gap, lim["rgb_mean_gap"])]

    def control(self, v: int) -> torch.Tensor:
        """The view rendered by the reference in the next lower precision."""
        return self.reference(v, ref_nerf.lower_precision(self.c)["lin"])
