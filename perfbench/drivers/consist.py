"""The consist driver: `Trainer.train` iterations of the CTE stage, the
DKMv3 matcher on the port's normal path.

Set-up is the train driver's, with the Trainer given a DKMv3 matcher
(`Trainer(cfg, matcher=DKMMatcher(model=DKM.from_state_dict(weights)))`,
the weights drawn from the seed at the configuration's `matcher` widths)
and its step at the traffic's `start_iter`; then the iteration that
crosses `noisenerf_start_iter` through `Trainer.train`: its consist pass at
weight 0 and its rematch (every train view rendered, every ordered pair
matched by `build_match_tables` and `DKMMatcher.match_many`); then
`check_steps` and `warm_iters` consist iterations on the fresh tables
(the first check step's consist batch drawn by the benchmark, see
`Driver._draw_consist`).  The encoder runs once on one view before the
crossing iteration, outside the program's spans, so that `dkm.encode`
reads warm passes, as a run's later rematches do.  All of it records the
program's spans (`trace.recording()`); their host seconds and counts by
name are the set-up's readings, with the views and ordered pairs the
rematch matched.

The window and the traced slice are the train driver's; the window also
reads the program's `train.consist` spans.  After the window the check
holds two things against the plain-PyTorch references:
  * the tables: for `check_pairs` ordered pairs drawn from the seed (one of
    them a view with itself), the program's rows against the reference's
    symmetric match (reference/dkm.py) of the renders the program matched,
    its query half at the program's columns, in pixels;
  * the check steps: the batch rows judged as the train driver judges them,
    each consist row of the program's own batches judged an entry of the
    tables at one anchor, and the steps against reference/consist.py from
    the weights and Adam's state the crossing iteration left: the loss,
    the first gradient, the change of the weights, the CTE terms and the
    first step's aligned render.  The first step's drawn batch makes its
    CTE term, and so the first gradient's CTE part, live.
The control: the program's matcher with TF32 allowed for the tables, the
reference in TF32 for the steps.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from perfbench import program, program_spans, work, work_dkm
from perfbench.harness import Check, Context, load_module
from perfbench.reference import consist as ref_consist
from perfbench.reference import dkm as ref_dkm
from perfbench.reference import train as ref_train
from perfbench.reference.nerf import lower_precision
from perfbench.scene import intrinsics, make_scene

_train = load_module(Path(__file__).with_name("train.py"), "perfbench_driver_train_base")
Base, train_gaps, worst = _train.Driver, _train.gaps, _train.worst

CTE_WEIGHT = 1e-2  # run_lushnerf.py:658, after noisenerf_start_iter
CTE_THRESHOLD = 0.8  # run_lushnerf.py:643
DRAWN_CERTAINTY = (0.6, 1.0)  # the first check step's: about half reach the threshold
TABLES = ("kpt_gap_px", "cert_gap")
STEPS = ("loss_gap", "grad_gap_median_leaf", "change_gap_median_leaf", "cte_term_gap",
         "cte_grad_gap", "aligned_rgb_gap")
SCENE_MLPS = ("mlp_coarse.", "mlp_fine.")  # the leaves the aligned render reaches
# The CTE pass is compared in this many groups of the drawn pixels (every
# view's), by the median group: at seeded weights a few rays' gradients are
# ill-conditioned in f32 (the f32 reference against a float64 one reads up
# to 1.7e-4 over the whole vector, all of it in one group of 100 rays)
CTE_GROUPS = 8


def pixel_groups(n: int) -> List[torch.Tensor]:
    """The CTE pass's groups of the n drawn pixels of every view."""
    return list(torch.arange(n).tensor_split(min(CTE_GROUPS, n)))


def dkm_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """DKMv3 weights from a seed, made on the device: convs U(-1/sqrt(fan
    in), 1/sqrt(fan in)) (torch's default), BatchNorm scales and variances
    U(0.5, 1.5), shifts and means N(0, 0.1^2)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bn = {k[: -len(".running_var")] for k in shapes if k.endswith(".running_var")}
    names = list(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    uni = torch.rand(sum(sizes), generator=gen, device=device)
    nrm = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for k, size in zip(names, sizes):
        mod, _, leaf = k.rpartition(".")
        u, n = uni[off:off + size].view(shapes[k]), nrm[off:off + size].view(shapes[k])
        if mod in bn:
            out[k] = (0.5 + u) if leaf in ("weight", "running_var") else 0.1 * n
        else:
            fan_in = math.prod(shapes[f"{mod}.weight"][1:])
            out[k] = (2.0 * u - 1.0) / math.sqrt(fan_in)
        off += size
    return {k: v.clone() for k, v in out.items()}


@contextlib.contextmanager
def tf32_allowed():
    """The program's matcher with TF32 on: its `full_f32` replaced."""
    from lushnerf_torch.matcher.dkm import matcher as dkm_matcher

    @contextlib.contextmanager
    def on():
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    real = dkm_matcher.full_f32
    dkm_matcher.full_f32 = on
    try:
        yield
    finally:
        dkm_matcher.full_f32 = real


class Driver(Base):
    def __init__(self, ctx: Context):
        super().__init__(ctx)
        self.m = ctx.config["matcher"]
        more = program.seeds(ctx.seed, "scene", "weights", "trainer", "draws", "dkm", "pairs",
                             "cte")
        self.seeds.update(dkm=more["dkm"], pairs=more["pairs"], cte=more["cte"])

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from lushnerf_torch.utils import trace

        since = time.perf_counter_ns()
        with trace.recording():
            self._setup()
        records = trace.spans(since, time.perf_counter_ns())
        spans_s: Dict[str, float] = {}
        counts: Dict[str, float] = {}
        for r in records:
            spans_s[r.name] = spans_s.get(r.name, 0.0) + r.ns / 1e9
            counts[r.name] = counts.get(r.name, 0) + 1
        V = len(self.renders)
        counts.update({"rematch.views": V, "rematch.pairs": V * V})
        self.setup_readings = {"spans_s": spans_s, "counts": counts}
        return self.setup_readings

    def _setup(self):
        from lushnerf_torch.matcher.dkm import matcher as dkm_matcher
        from lushnerf_torch.matcher.dkm.matcher import DKM, DKMMatcher
        from lushnerf_torch.ops.fused import build, nerf_mlp
        from lushnerf_torch.train import trainer as trainer_mod

        dev, m = self.ctx.device, self.m
        s = self.cfg_entry["scene"]
        self.tmp = tempfile.TemporaryDirectory(prefix="perfbench_")
        cfg = program.make_config(self.cfg_entry, **self.tr["config_overrides"],
                                  basedir=f"{self.tmp.name}/logs", tbdir=f"{self.tmp.name}/tb",
                                  seed=self.seeds["trainer"])
        if dev.type == "cuda":
            lc = cfg.lush_config()
            build.build_all(nerf_mlp.kernel_builds([lc.mlp_cfg, lc.mlp_cfg_fine], lc.render))
        self.scene = make_scene(self.seeds["scene"], s["views"], s["height"], s["width"],
                                s["focal"])
        self.dkm = dkm_weights(self._dkm_shapes(), self.seeds["dkm"], dev)
        self.matcher = DKMMatcher(model=DKM.from_state_dict(self.dkm).to(dev), hs=m["hs"],
                                  ws=m["ws"], max_columns=m["max_columns"],
                                  pair_batch=m["pair_batch"], conv_dtype=m["conv_dtype"])
        with torch.inference_mode(), dkm_matcher.full_f32():
            self.matcher.encode(self.scene["images"], [0])  # a process's first convolutions
        self.renders = None
        real_many = self.matcher.match_many

        def match_many(images, pairs):
            self.renders = images  # what the rematch matched
            return real_many(images, pairs)

        self.matcher.match_many = match_many
        trainer = trainer_mod.Trainer(cfg, data=self.scene, matcher=self.matcher, device=dev)
        trainer.setup()
        self.trainer, self.trainer_mod = trainer, trainer_mod
        self.aligned_rays = len(trainer.i_train) * cfg.consist_num_pixels
        self.weights = self._weights(trainer.model)
        program.load_weights(trainer.model, self.weights)
        trainer.step = self.tr["start_iter"]
        self._wrap()
        trainer.train(cfg.noisenerf_start_iter)  # the consist pass at weight 0, the rematch
        del self.matcher.match_many
        if self.renders is None:
            raise RuntimeError("the crossing iteration made no rematch through match_many")
        self.tables = trainer.match_tables
        del self.losses[:]
        self._snapshot()
        self._draw_consist()
        self.check_data["cte"] = self._cte_pass()
        self._check_steps()
        self._unwrap_check()
        trainer.train(trainer.step + self.tr["warm_iters"])

    def _dkm_shapes(self) -> Dict[str, tuple]:
        from lushnerf_torch.matcher.dkm.matcher import DKMDims, state_shapes

        m = self.m
        return state_shapes(DKMDims(resnet_width=m["resnet_width"], gp_dim=m["gp_dim"],
                                    feat_dim=m["feat_dim"], proj_dim=m["proj_dim"],
                                    disp_emb=tuple(m["disp_emb"]),
                                    hidden_mult=tuple(m["hidden_mult"])))

    def _snapshot(self):
        """The state the crossing iteration left: the weights, Adam's
        moments and count, and the updates made before the check steps."""
        trainer = self.trainer
        names = {p: k for k, p in trainer.model.named_parameters()}
        adam = {"t": None}
        for p, k in names.items():
            st = trainer.optimizer.state[p]
            adam["t"] = int(st["step"])
            adam[("m", k)] = st["exp_avg"].detach().clone()
            adam[("v", k)] = st["exp_avg_sq"].detach().clone()
        self.start = {"weights": {k: p.detach().clone() for p, k in names.items()}, "adam": adam,
                      "updates": trainer.step - self.tr["start_iter"]}

    def _wrap(self):
        """The train driver's spans and draws, and for the check steps the
        consist batch, the first gradient as Adam takes it, the CTE term and
        the aligned render."""
        super()._wrap()
        mod, trainer = self.trainer_mod, self.trainer
        inner_step, inner_adam = mod.train_step, trainer.optimizer.step
        real_render, real_cte = mod.render_aligned_pixels, mod.consistency_loss
        self._unwrapped = (inner_step, inner_adam, real_render, real_cte)
        names = {p: k for k, p in trainer.model.named_parameters()}

        def train_step(*args, **kwargs):
            if self.inject:
                c = kwargs.get("consist")
                self.inject[0]["consist"] = None if c is None else {
                    k: v.clone() if torch.is_tensor(v) else v for k, v in c.items()}
            return inner_step(*args, **kwargs)

        def render(*args, **kwargs):
            out = real_render(*args, **kwargs)
            if self.inject:
                self.inject[0]["rgb"] = out.detach().clone()
            return out

        def cte(*args, **kwargs):
            out = real_cte(*args, **kwargs)
            if self.inject:
                self.inject[0]["term"] = float(out.detach())
            return out

        def adam(*args, **kwargs):
            if self.inject and "grad" not in self.inject[0]:
                self.inject[0]["grad"] = {names[p]: p.grad.detach().clone()
                                          for p in trainer.model.parameters()}
            return inner_adam(*args, **kwargs)

        adam._wrapped_by_lr_sched = True
        mod.train_step, mod.render_aligned_pixels, mod.consistency_loss = train_step, render, cte
        trainer.optimizer.step = adam

    def _unwrap_check(self):
        """The check steps' wrappers taken off: the warm-up and the window
        run the train driver's wrappers around the program's functions."""
        mod = self.trainer_mod
        inner_step, inner_adam, real_render, real_cte = self._unwrapped
        mod.train_step, mod.render_aligned_pixels, mod.consistency_loss = (
            inner_step, real_render, real_cte)
        self.trainer.optimizer.step = inner_adam

    def _draw_consist(self):
        """Consist pixels and certainties drawn by the benchmark: each
        view's own pixels over the whole frame, certainties
        U(DRAWN_CERTAINTY).  The seeded matcher's tables hold no certainty
        that reaches the threshold, and their pixels gather near the
        frame's middle, where the seeded scene's radiance is the same in
        every view; drawn so, the CTE term and its gradient are live, and
        the threshold splits the entries."""
        trainer, dev = self.trainer, self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(self.seeds["cte"])
        V, n = len(trainer.i_train), trainer.cfg.consist_num_pixels
        u = torch.rand((V, n, 3), generator=gen, device=dev)
        lo, hi = DRAWN_CERTAINTY
        self.drawn = {"align_pix": u[..., :2] * torch.tensor([trainer.W, trainer.H], device=dev),
                      "certainty": lo + (hi - lo) * u[..., 2]}

    def _cte_pass(self) -> List[dict]:
        """The program's CTE pass alone (`render_aligned_pixels`, then
        `consistency_loss`, as `loss_fn` calls them) on each group of the
        drawn pixels and certainties (`pixel_groups`), from the weights the
        crossing iteration left: a group's term and its gradient over the
        scene MLPs' leaves."""
        trainer, mod = self.trainer, self.trainer_mod
        leaves = {k: p for k, p in trainer.model.named_parameters() if k.startswith(SCENE_MLPS)}
        out = []
        for cols in pixel_groups(self.drawn["align_pix"].shape[1]):
            rgb = mod.render_aligned_pixels(trainer.model, trainer.lush_cfg, trainer.H, trainer.W,
                                            trainer._consist_K, trainer._consist_poses,
                                            self.drawn["align_pix"][:, cols])
            term = mod.consistency_loss(rgb, self.drawn["certainty"][:, cols],
                                        trainer.cfg.consist_threshold)
            grads = (torch.autograd.grad(term, list(leaves.values()), allow_unused=True)
                     if term.requires_grad else [None] * len(leaves))
            out.append({"term": float(term.detach()),
                        "grad": {k: torch.zeros_like(p) if g is None else g.detach()
                                 for (k, p), g in zip(leaves.items(), grads)}})
        return out

    def _drawn_batch(self):
        """`Trainer._sample_consist_batch` giving the program's batch with
        the drawn pixels and certainties in it."""
        sample = self.trainer._sample_consist_batch

        def drawn(i):
            batch = sample(i)  # the program's stream of draws moves on as it would
            batch.update(align_pix=self.drawn["align_pix"].clone(),
                         certainty=self.drawn["certainty"].clone())
            return batch

        return drawn

    def _check_steps(self):
        """The check steps through `Trainer.train`: the first on the drawn
        consist batch (`_draw_consist`), the others on the program's own."""
        trainer, c = self.trainer, self.c
        gen = torch.Generator(device=self.ctx.device).manual_seed(self.seeds["draws"])
        rays = c["N_rand"] * (c["rbk_num_motion"] + 1)
        steps = []
        for n in range(self.tr["check_steps"]):
            self.inject.append({"draws": self._draws(gen, rays), "drawn": n == 0})
            if n == 0:
                trainer._sample_consist_batch = self._drawn_batch()
            trainer.train(trainer.step + 1)
            if n == 0:
                del trainer._sample_consist_batch
            steps.append(self.inject.pop())
        self.check_data["steps"] = steps
        self.check_data["losses"] = [float(x) for x in self.losses[:len(steps)]]
        self.check_data["terms"] = [s["term"] for s in steps]
        self.check_data["grad"] = steps[0]["grad"]
        self.check_data["rgb"] = steps[0]["rgb"]
        self.check_data["after"] = {k: p.detach().clone()
                                    for k, p in trainer.model.named_parameters()}

    # -- the window ------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        from lushnerf_torch.utils import trace

        since = time.perf_counter_ns()
        win = super().window(seconds)
        got = program_spans.by_unit(trace.spans(since, time.perf_counter_ns()),
                                    ("train.iteration", "train.consist"), win["units"])
        if "train.consist" in got:
            win["spans_s"]["train.consist"] = got["train.consist"]
        return win

    def work(self) -> dict:
        """The train driver's work with the aligned render's rays added (V
        x consist_num_pixels rays a step, the sharp branch at eval's
        samples: no RBK sub-rays; the weights counted once a step), and
        DKMv3's."""
        m, c = self.m, self.c
        out = dict(super().work())
        pts = self.aligned_rays * (2 * c["N_samples"] + c["N_importance"])
        fwd = pts * work.flop_per_point(c["netwidth"], c["multires"], c["multires_views"])
        out.update(fwd_flop=out["fwd_flop"] + fwd, bwd_flop=out["bwd_flop"] + 2 * fwd,
                   model_flop=out["model_flop"] + 3 * fwd,
                   fwd_bytes=out["fwd_bytes"] + work.fwd_bytes(pts, 0),
                   bwd_bytes=out["bwd_bytes"] + work.bwd_bytes(pts, 0))
        out["dkm_view_flop"] = work_dkm.encoder_flop(m["resnet_width"], m["hs"], m["ws"])
        out["dkm_pair_flop"] = work_dkm.decoder_flop(
            m["resnet_width"], m["gp_dim"], m["feat_dim"], m["proj_dim"], m["disp_emb"],
            m["hidden_mult"], m["hs"], m["ws"])
        return out

    # -- the check ------------------------------------------------------------
    def check_pairs(self) -> List[tuple]:
        """`check_pairs` ordered pairs from the seed: distinct views, and the
        last a view with itself."""
        rng = np.random.default_rng(self.seeds["pairs"])
        V = len(self.renders)
        n = self.tr["check_pairs"]
        pairs = [tuple(int(x) for x in rng.choice(V, 2, replace=False)) for _ in range(n - 1)]
        k = int(rng.integers(V))
        return pairs + [(k, k)]

    def table_rows(self, pairs, kpts=None, cert=None) -> dict:
        """The rows of the pairs: the program's tables' (or the given
        kpts [n, P, 4] and cert [n, P])."""
        if kpts is None:
            kpts = np.stack([self.tables.kpts[k, v] for k, v in pairs])
            cert = np.stack([self.tables.certainty[k, v] for k, v in pairs])
        return {"kpts": np.asarray(kpts, np.float32), "cert": np.asarray(cert, np.float32)}

    def reference_rows(self, pairs) -> dict:
        """The reference's symmetric match of each pair's renders, its query
        half at the program's columns (max_columns spread by linspace), in
        the renders' pixels brought to the scene's."""
        m, dev = self.m, self.ctx.device
        hs, ws = m["hs"], m["ws"]
        Hr, Wr = self.renders.shape[1:3]
        H, W = self.scene["hwf"][:2]
        P = hs * ws
        idx = np.arange(P)
        if m["max_columns"] and P > m["max_columns"]:
            idx = np.linspace(0, P - 1, m["max_columns"]).astype(int)
        idx = torch.as_tensor(idx, device=dev)
        kp, ce = [], []
        for k, v in pairs:
            im0, im1 = (torch.as_tensor(self.renders[i], device=dev).permute(2, 0, 1)
                        for i in (k, v))
            warp, cert = ref_dkm.match(self.dkm, im0, im1, hs, ws)
            q = warp[:, :ws].reshape(-1, 4)[idx]
            c = cert[:, :ws].reshape(-1)[idx]
            px = torch.stack([Wr * (q[:, 0] + 1) / 2, Hr * (q[:, 1] + 1) / 2,
                              Wr * (q[:, 2] + 1) / 2, Hr * (q[:, 3] + 1) / 2], dim=-1)
            scale = torch.tensor([W / Wr, H / Hr] * 2, device=dev)
            kp.append((px * scale if (Hr, Wr) != (H, W) else px).cpu().numpy())
            ce.append(c.cpu().numpy())
        return {"kpts": np.stack(kp), "cert": np.stack(ce)}

    def control_rows(self, pairs) -> dict:
        """The program's matcher on the pairs with TF32 allowed."""
        with tf32_allowed():
            kpts, cert = self.matcher.match_many(self.renders, pairs)
        return self.table_rows(pairs, kpts, cert)

    def judge_consist(self, consist: dict) -> int:
        """Entries of the consist batch ([V, n] pixels and certainties) that
        are not the tables' at one anchor: for the anchor that holds most
        of its columns, the columns it does not hold, each counted once a
        view."""
        pix = consist["align_pix"].cpu().numpy()
        cert = consist["certainty"].cpu().numpy()
        V, n = cert.shape
        best = 0
        for a in range(self.tables.num_views):
            kp, ce = self.tables.kpts[a][..., 2:4], self.tables.certainty[a]  # [V, P, ...]
            held = 0
            for j in range(n):
                cand = np.nonzero((kp[0] == pix[0, j]).all(-1) & (ce[0] == cert[0, j]))[0]
                held += any((kp[:, c] == pix[:, j]).all() and (ce[:, c] == cert[:, j]).all()
                            for c in cand)
            best = max(best, held)
        return V * (n - best)

    def reference(self, precision: Dict[str, str], cte_weight: float = CTE_WEIGHT) -> dict:
        """The reference's check steps from the state the crossing iteration
        left, on rows it builds again after judging the program's; the CTE
        term at `cte_weight`."""
        c, dev, scene = self.c, self.ctx.device, self.scene
        n = len(scene["poses"])
        test = np.arange(n)[:: c["llffhold"]]
        train_views = np.array([i for i in range(n) if i not in set(test)])
        u8 = (scene["images"][train_views] * 255).astype(np.uint8)
        levels = ref_train.frequency_levels(u8, c["fq_threshold"], dev)
        H, W, focal = scene["hwf"]
        K = torch.as_tensor(intrinsics(H, W, focal), device=dev)
        poses = torch.as_tensor(scene["poses"][train_views], device=dev)
        steps, wrong, cwrong = [], 0, 0
        for s in self.check_data["steps"]:
            if s["stage"] != "allkernel" or s.get("consist") is None:
                raise ValueError(f"the reference covers allkernel + consist; got {s['stage']}")
            judged = ref_train.judge_batch(s["batch"], scene, levels, train_views)
            wrong += judged["wrong"]
            if not s["drawn"]:
                cwrong += self.judge_consist(s["consist"])
            consist = {"K": K, "poses": poses, "align_pix": s["consist"]["align_pix"],
                       "certainty": s["consist"]["certainty"], "weight": cte_weight,
                       "threshold": CTE_THRESHOLD}
            steps.append({"rays": judged["rays"], "idx": judged["idx"], "rgbs": judged["rgbs"],
                          "draws": s["draws"], "consist": consist})
        del levels
        out = ref_consist.reference_steps(self.start["weights"], self.start["adam"], c, scene,
                                          steps, precision, self.start["updates"])
        leaves = [k for k in self.start["weights"] if k.startswith(SCENE_MLPS)]
        out.update(rows_wrong=wrong, consist_rows_wrong=cwrong, cte=[
            ref_consist.cte_pass(self.start["weights"], c, scene,
                                 {"K": K, "poses": poses, "threshold": CTE_THRESHOLD,
                                  "align_pix": self.drawn["align_pix"][:, cols],
                                  "certainty": self.drawn["certainty"][:, cols]},
                                 precision, leaves)
            for cols in pixel_groups(self.drawn["align_pix"].shape[1])])
        return out

    def check(self, win: dict) -> List[Check]:
        pairs = self.check_pairs()
        ref_rows = self.reference_rows(pairs)
        ref = self.reference({"lin": "f32", "lin_other": "f32"})
        return self.compare(self.check_data, ref, self.table_rows(pairs), ref_rows)

    def compare(self, prog: dict, ref: dict, rows: dict, ref_rows: dict) -> List[Check]:
        lim = self.ctx.limits
        nums = dict(step_gaps(prog, ref, self.start["weights"]), **table_gaps(rows, ref_rows))
        return [Check("batch_rows_wrong", float(ref["rows_wrong"]), lim["batch_rows_wrong"]),
                Check("consist_rows_wrong", float(ref["consist_rows_wrong"]),
                      lim["consist_rows_wrong"])] + [
            Check(name, nums[name], lim[name]) for name in TABLES + STEPS]

    def control(self, precision=None, cte_weight: float = CTE_WEIGHT) -> dict:
        """The steps' reference in the next lower precision (or the given
        one, at the given CTE weight), put in the program's place."""
        low = self.reference(precision or lower_precision(self.c), cte_weight)
        return {"losses": low["losses"], "terms": low["terms"], "grad": low["grad"],
                "rgb": low["rgb"], "after": low["after"], "cte": low["cte"]}

    def readings(self) -> dict:
        """The check's numbers of the program, of the control (the matcher
        with TF32 allowed, the steps' reference in TF32) and of the fault
        "no CTE term" (the f32 reference at CTE weight 0 in the program's
        place, its tables the program's), each against the references;
        beside them the worst leaves' gaps and the tables' details."""
        pairs = self.check_pairs()
        ref_rows = self.reference_rows(pairs)
        ref = self.reference({"lin": "f32", "lin_other": "f32"})
        rows = self.table_rows(pairs)
        ctl_rows = self.control_rows(pairs)
        no_cte = self.control({"lin": "f32", "lin_other": "f32"}, 0.0)
        no_cte["cte"] = [{"term": 0.0, "grad": {k: torch.zeros_like(g)
                                                 for k, g in r["grad"].items()}}
                         for r in ref["cte"]]
        got = {"program": (self.check_data, rows), "control": (self.control(), ctl_rows),
               "no_cte": (no_cte, rows)}
        out = {"pairs": pairs}
        for name, (steps, tables) in got.items():
            out[name] = {c.name: c.value for c in self.compare(steps, ref, tables, ref_rows)}
            leaves = train_gaps(steps, ref, self.start["weights"])
            out[name + "_leaves"] = {k: leaves[k] for k in (
                "grad_gap_worst_leaf", "change_gap_worst_leaf", "worst_grad_leaf",
                "worst_change_leaf")}
            out[name + "_detail"] = table_detail(tables, ref_rows)
        out["terms"] = {"program": self.check_data["terms"], "reference": ref["terms"],
                        "cte_pass": [[g["term"] for g in self.check_data["cte"]],
                                     [g["term"] for g in ref["cte"]]]}
        return out


def step_gaps(prog: dict, ref: dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The train driver's gaps (loss, first gradient, change of the weights
    from `start`); the CTE term's and the aligned render's: the worst
    step's |term - reference| over the reference's term (or over 1 where
    the reference's is 0: no confident entry), the largest gap of the
    first step's aligned rgb, and the CTE pass's own gradient over the
    scene MLPs' leaves: |g - g_ref| / |g_ref|, the vectors whole, in the
    median pixel group (`CTE_GROUPS`).  (The steps' leaf-norm gaps cannot
    see the CTE part of a gradient: most leaves take none of it, and a
    leaf's norm moves by the square of a small part at right angles to it.
    The fault "no CTE term" reads a median-leaf gradient gap of 0.)"""
    nums = train_gaps(prog, ref, start)
    groups = []
    for gp, gr in zip(prog["cte"], ref["cte"], strict=True):
        names = sorted(gr["grad"])
        g_p, g_r = (torch.cat([g["grad"][k].double().flatten() for k in names])
                    for g in (gp, gr))
        den = torch.linalg.vector_norm(g_r)
        gap = torch.linalg.vector_norm(g_p - g_r)
        groups.append(float(gap / den) if den > 0 else (math.inf if gap > 0 else 0.0))
    nums["cte_grad_gap"] = statistics.median(groups)
    nums["cte_term_gap"] = worst(abs(p - r) / (abs(r) if r != 0 else 1.0)
                                  for p, r in zip(prog["terms"], ref["terms"]))
    nums["aligned_rgb_gap"] = float((prog["rgb"].float() - ref["rgb"].float()).abs().max())
    return nums


def table_gaps(rows: dict, ref: dict) -> Dict[str, float]:
    """The tables' gaps over the pairs' columns: the largest keypoint gap in
    pixels and the largest certainty gap (a certainty zeroed on one side
    alone, by the `wrong` mask, reads as the other's certainty)."""
    kp = np.abs(rows["kpts"].astype(np.float64) - ref["kpts"])
    ce = np.abs(rows["cert"].astype(np.float64) - ref["cert"])
    return {"kpt_gap_px": float(kp.max()) if np.isfinite(kp).all() else float("inf"),
            "cert_gap": float(ce.max()) if np.isfinite(ce).all() else float("inf")}


def table_detail(rows: dict, ref: dict) -> Dict[str, float]:
    """Beside the compared numbers: the keypoint gap's median and 99th
    percentile, the reference's certainties' mean, least, zero share and
    confident share, and the share of columns whose certainty is zero, or
    confident, on one side alone."""
    kp = np.abs(rows["kpts"].astype(np.float64) - ref["kpts"]).max(axis=-1)
    conf, conf_ref = rows["cert"] >= CTE_THRESHOLD, ref["cert"] >= CTE_THRESHOLD
    return {"kpt_gap_median_px": float(np.median(kp)),
            "kpt_gap_p99_px": float(np.quantile(kp, 0.99)),
            "cert_mean": float(ref["cert"].mean()), "cert_min": float(ref["cert"].min()),
            "cert_zero_share": float((ref["cert"] == 0).mean()),
            "cert_confident_share": float(conf_ref.mean()),
            "cert_zero_disagree_share": float(((rows["cert"] == 0) != (ref["cert"] == 0)).mean()),
            "cert_confident_disagree_share": float((conf != conf_ref).mean())}
