"""The training driver: `Trainer.train` iterations, as a user's run makes
them after the warm-up stage.

Set-up builds one Trainer on the scene made from the seed, puts the
benchmark's weights into its model and sets its step to the traffic's
`start_iter`.  Its first `check_steps` iterations go through
`Trainer.train`, with the benchmark's draws given to `train_step` as
`rand_override` and the state around them kept for the check; then
`warm_iters` more.  The window calls `Trainer.train` `chunk_iters`
iterations at a time until `--seconds` have passed, then synchronises:
train_rays_per_s is N_rand x the iterations completed over that time.
The program's spans record over the window (`trace.recording()`), and
its `train.iteration` and `train.step` give the loop's and the step's host
time of an untraced iteration.

The benchmark's own host spans wrap `trainer.train_step` (as chip_smoke.py
wraps it), `trainer.loss_fn` (the forward) and the optimizer's step: the
traced slice's idle gaps are labelled by them.
"""

from __future__ import annotations

import gc
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import program, program_spans, work
from perfbench.harness import Check, Context, sync
from perfbench.reference import train as ref_train
from perfbench.reference.nerf import lower_precision
from perfbench.scene import make_scene


class Driver:
    unit = "iter"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.cfg_entry = ctx.config
        self.c = ctx.config["config"]
        self.tr = ctx.traffic
        self.seeds = program.seeds(ctx.seed, "scene", "weights", "trainer", "draws")
        self.spans: List[tuple] = []
        self.losses: List[torch.Tensor] = []
        self.check_data: Dict[str, object] = {}

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from lushnerf_torch.ops.fused import build, nerf_mlp
        from lushnerf_torch.train import trainer as trainer_mod

        dev = self.ctx.device
        s = self.cfg_entry["scene"]
        self.tmp = tempfile.TemporaryDirectory(prefix="perfbench_")
        cfg = program.make_config(self.cfg_entry, **self.tr["config_overrides"],
                                  basedir=f"{self.tmp.name}/logs", tbdir=f"{self.tmp.name}/tb",
                                  seed=self.seeds["trainer"])
        if dev.type == "cuda":  # this cell's kernel sources, side by side, before the first step
            lc = cfg.lush_config()
            build.build_all(nerf_mlp.kernel_builds([lc.mlp_cfg, lc.mlp_cfg_fine], lc.render))
        self.scene = make_scene(self.seeds["scene"], s["views"], s["height"], s["width"],
                                s["focal"])
        trainer = trainer_mod.Trainer(cfg, data=self.scene, device=dev)
        trainer.setup()
        self.trainer, self.trainer_mod = trainer, trainer_mod
        self.weights = self._weights(trainer.model)
        program.load_weights(trainer.model, self.weights)
        trainer.step = self.tr["start_iter"]
        self._wrap()
        self._check_steps()
        trainer.train(trainer.step + self.tr["warm_iters"])

    def _weights(self, model):
        from perfbench.weights import make_weights

        return make_weights(program.named_shapes(model), self.seeds["weights"],
                            self.ctx.device)

    def _wrap(self):
        """The benchmark's spans around train_step, loss_fn and Adam's step;
        during the check steps train_step also takes the benchmark's draws."""
        mod, trainer = self.trainer_mod, self.trainer
        real_step, real_loss, real_adam = mod.train_step, mod.loss_fn, trainer.optimizer.step
        spans, losses = self.spans, self.losses
        self.inject: List[dict] = []

        def train_step(*args, **kwargs):
            if self.inject:
                kwargs["rand_override"] = self.inject[0]["draws"]
                self.inject[0]["batch"] = {k: v.clone() for k, v in args[7].items()}
                self.inject[0]["stage"] = args[8]
            t0 = time.perf_counter_ns()
            loss, mse = real_step(*args, **kwargs)
            spans.append(("train_step", t0, time.perf_counter_ns()))
            losses.append(loss)
            return loss, mse

        def loss_fn(*args, **kwargs):
            t0 = time.perf_counter_ns()
            out = real_loss(*args, **kwargs)
            spans.append(("forward", t0, time.perf_counter_ns()))
            return out

        def adam(*args, **kwargs):
            t0 = time.perf_counter_ns()
            out = real_adam(*args, **kwargs)
            spans.append(("adam", t0, time.perf_counter_ns()))
            return out

        # torch's LR scheduler warns where optimizer.step is not its own
        # wrapper; this one calls that wrapper
        adam._wrapped_by_lr_sched = True
        self._real = (real_step, real_loss)
        mod.train_step, mod.loss_fn, trainer.optimizer.step = train_step, loss_fn, adam

    def _draws(self, gen: torch.Generator, rays: int) -> Dict[str, torch.Tensor]:
        """One step's randomness, the shapes of the program's own draws
        (lushnerf_torch.models.lushnerf._train_randomness)."""
        c, dev = self.c, self.ctx.device
        S, SI, std = c["N_samples"], c["N_importance"], c["raw_noise_std"]
        return {"t_rand": torch.rand((rays, S), generator=gen, device=dev),
                "u_importance": torch.rand((rays, SI), generator=gen, device=dev),
                "density_noise_coarse": torch.randn((rays, S - 1), generator=gen, device=dev) * std,
                "density_noise_fine": torch.randn((rays, S + SI - 1), generator=gen,
                                                  device=dev) * std}

    def _check_steps(self):
        """The first iterations, through Trainer.train, on the benchmark's
        draws; the first gradient (from Adam's state after one step) and the
        change of the weights after the last are kept for the check."""
        trainer, c = self.trainer, self.c
        gen = torch.Generator(device=self.ctx.device).manual_seed(self.seeds["draws"])
        rays = c["N_rand"] * (c["rbk_num_motion"] + 1)
        steps = []
        for n in range(self.tr["check_steps"]):
            self.inject.append({"draws": self._draws(gen, rays)})
            trainer.train(trainer.step + 1)
            steps.append(self.inject.pop())
            if n == 0:
                b1 = trainer.optimizer.param_groups[0]["betas"][0]
                names = {p: k for k, p in trainer.model.named_parameters()}
                self.check_data["grad"] = {
                    names[p]: st["exp_avg"] / (1 - b1) if "exp_avg" in st else None
                    for p, st in ((p, trainer.optimizer.state.get(p, {}))
                                  for p in trainer.model.parameters())}
        self.check_data["steps"] = steps
        self.check_data["losses"] = [float(x) for x in self.losses[:len(steps)]]
        self.check_data["after"] = {k: p.detach().clone()
                                    for k, p in trainer.model.named_parameters()}

    # -- the window ------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        from lushnerf_torch.utils import trace

        trainer, dev = self.trainer, self.ctx.device
        chunk = self.tr["chunk_iters"]
        del self.losses[:]
        del self.spans[:]
        program.zero_launches()
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        first = trainer.step
        since = time.perf_counter_ns()
        t0 = time.perf_counter()
        with trace.recording():
            while time.perf_counter() - t0 < seconds:
                a = time.perf_counter_ns()
                trainer.train(trainer.step + chunk)
                self.spans.append(("loop", a, time.perf_counter_ns()))
        sync(dev)
        elapsed = time.perf_counter() - t0
        units = trainer.step - first
        failed = int((~torch.isfinite(torch.stack(self.losses))).sum())
        spans_s: Dict[str, float] = {}
        for name, a, b in self.spans:
            spans_s[name] = spans_s.get(name, 0.0) + (b - a) / 1e9
        spans_s.update(program_spans.by_unit(trace.spans(since, time.perf_counter_ns()),
                                             ("train.iteration", "train.step"), units))
        parts = [(b - a) / 1e6 / chunk for n, a, b in self.spans if n == "loop"]
        return {"units": units, "seconds": elapsed, "failed": failed, "spans_s": spans_s,
                "parts_ms": parts,
                "launches": program.read_launches(),
                "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}

    def traced_slice(self):
        from perfbench import devtrace

        trainer = self.trainer
        del self.spans[:]

        def run():
            first = trainer.step
            a = time.perf_counter_ns()
            trainer.train(trainer.step + self.tr["trace_iters"])
            self.spans.append(("trainer_loop", a, time.perf_counter_ns()))
            return trainer.step - first

        return devtrace.trace(run, self.spans)

    def end_to_end(self, win: dict) -> dict:
        return {"train_rays_per_s": self.c["N_rand"] * win["units"] / win["seconds"]}

    def work(self) -> dict:
        c = self.c
        pts = work.train_points(c["N_rand"], c["rbk_num_motion"] + 1, c["N_samples"],
                                c["N_importance"])
        fwd = pts * work.flop_per_point(c["netwidth"], c["multires"], c["multires_views"])
        n_params = work.mlp_params(c["netwidth"], work.pe_channels(c["multires"]),
                                   work.pe_channels(c["multires_views"]))
        return {"fwd_flop": fwd, "bwd_flop": 2 * fwd, "model_flop": 3 * fwd,
                "fwd_bytes": work.fwd_bytes(pts, 2 * n_params),
                "bwd_bytes": work.bwd_bytes(pts, 2 * n_params)}

    # -- the check ------------------------------------------------------------
    def release(self):
        """Frees the program's state; the check keeps what it needs."""
        self.trainer_mod.train_step, self.trainer_mod.loss_fn = self._real
        if self.trainer.tb is not None:
            self.trainer.tb.close()
        self.trainer = None
        self.tmp.cleanup()
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: Dict[str, str], half_batch: bool = False,
                  dtype: torch.dtype = torch.float32) -> dict:
        """The reference's steps from the benchmark's weights and draws, on
        rows it builds again after judging the program's."""
        c, dev, scene = self.c, self.ctx.device, self.scene
        n = len(scene["poses"])
        test = np.arange(n)[:: c["llffhold"]]
        train_views = np.array([i for i in range(n) if i not in set(test)])
        u8 = (scene["images"][train_views] * 255).astype(np.uint8)
        levels = ref_train.frequency_levels(u8, c["fq_threshold"], dev)
        steps, wrong = [], 0
        for s in self.check_data["steps"]:
            if s["stage"] != "kernel":
                raise ValueError(f"the reference covers the kernel stage; got {s['stage']}")
            judged = ref_train.judge_batch(s["batch"], scene, levels, train_views)
            wrong += judged["wrong"]
            steps.append({**judged, "draws": s["draws"]})
        del levels
        losses, grads, after = ref_train.reference_steps(self.weights, c, scene, steps,
                                                         precision, half_batch, dtype)
        return {"losses": losses, "grad": grads, "after": after, "rows_wrong": wrong}

    def check(self, win: dict) -> List[Check]:
        ref = self.reference({"lin": "f32", "lin_other": "f32"})
        return self.compare(self.check_data, ref)

    def gaps_of(self, prog: dict, ref: dict) -> dict:
        return gaps(prog, ref, self.weights)

    def compare(self, prog: dict, ref: dict) -> List[Check]:
        lim = self.ctx.limits
        nums = gaps(prog, ref, self.weights)
        return [Check("batch_rows_wrong", float(ref["rows_wrong"]), lim["batch_rows_wrong"])] + [
            Check(name, nums[name], lim[name]) for name in COMPARED]

    def control(self) -> dict:
        """The reference in the next lower precision, put in the program's
        place."""
        low = self.reference(lower_precision(self.c))
        return {"losses": low["losses"], "grad": low["grad"], "after": low["after"]}


COMPARED = ("loss_gap", "grad_gap_median_leaf", "change_gap_median_leaf")


def worst(values) -> float:
    """The largest value; infinity where any is not finite."""
    values = list(values)
    return max(values) if all(np.isfinite(values)) else float("inf")


def median(values) -> float:
    values = list(values)
    return float(np.median(values)) if all(np.isfinite(values)) else float("inf")


def _norms(d: dict) -> Dict[str, float]:
    return {k: (float(torch.linalg.vector_norm(v.double())) if v is not None else float("nan"))
            for k, v in d.items()}


def gaps(prog: dict, ref: dict, weights: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """The numbers compared: the worst step's loss gap over the reference's
    loss; and, leaf by leaf, the gap between the program's and the
    reference's norms of the first gradient, and of the weights' change over
    the steps, each over that leaf's reference norm or the median leaf's,
    whichever is larger: their median over the leaves is compared, their
    worst is reported beside it.  The change leaves out leaves whose
    reference gradient is under a thousandth of the median leaf's (moved
    by round-off alone under Adam)."""
    loss_gap = worst(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    gp, gr = _norms(prog["grad"]), _norms(ref["grad"])
    g_med = float(np.median(list(gr.values())))
    grad = {k: abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr}
    moved = [k for k in gr if gr[k] >= 1e-3 * g_med]
    dp = _norms({k: prog["after"][k] - weights[k] for k in moved})
    dr = _norms({k: ref["after"][k] - weights[k] for k in moved})
    d_med = float(np.median(list(dr.values())))
    change = {k: abs(dp[k] - dr[k]) / max(dr[k], d_med) for k in moved}
    return {"loss_gap": loss_gap,
            "grad_gap_median_leaf": median(grad.values()),
            "change_gap_median_leaf": median(change.values()),
            "grad_gap_worst_leaf": worst(grad.values()),
            "change_gap_worst_leaf": worst(change.values()),
            "worst_grad_leaf": max(grad, key=lambda k: grad[k]),
            "worst_change_leaf": max(change, key=lambda k: change[k])}
