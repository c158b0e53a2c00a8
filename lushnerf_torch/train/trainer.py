"""The trainer of LuSh-NeRF: the staged loop over one training step, eval,
checkpoints and render-only, a port of lushnerf_tpu's `Trainer`.

    trainer = Trainer(cfg, device="cuda")   # or Trainer(cfg, data={...})
    trainer.setup()
    trainer.train()

One step (`train_step`) is the staged loss, Adam with the reference's
exponential learning-rate decay, and the optional global-norm clip (the
step of lushnerf_tpu's `Trainer._loss_fn` / `step_fn`):

    opt, sched = make_optimizer(cfg, model)
    loss, mse = train_step(model, opt, sched, cfg.lush_config(), H, W, focal,
                           batch, stage, generator, grad_clip_norm=cfg.grad_clip_norm)

`batch` holds tensors on the model's device: rays [N, 3, 2], rgbs [N, 3],
images_idx [N] or [N, 1] (int), fq_mask [N] (bool or uint8).

From noisenerf_start_iter on, a step also takes a consist batch
(`consist`: the train poses, each view's pixels matched to the anchor's
sampled columns, their certainties, the CTE weight) and adds
weight * consistency_loss(render_aligned_pixels(...)) to the stage's loss,
in the same backward and Adam step (lushnerf_tpu's `_loss_fn_consist`).
The match tables live on the host; every rematch_interval iterations the
matcher (`cfg.matcher`: stub, gt, dkm; precomputed tables come from
match_table_path) rebuilds them from renders of the train views, and they
are saved beside the checkpoints and reloaded on resume.

The loop adds no host work a step beyond Python: the ray dataset lives on
the device (a batch is an index_select), randomness comes from a device
`torch.Generator`, and the loss reaches the host only at the i_print /
i_tensorboard cadence (every step under debug_nan_check).  A consist
iteration adds a numpy gather of V x consist_num_pixels table entries and
two small uploads from pinned memory, without a sync.

Under a process group (`lushnerf_torch.parallel.distributed`: torchrun, or
the coordinator flags; one process per card) the trainer is data-parallel,
line for line as lushnerf_tpu's `Trainer` across processes: each rank
draws N_rand / world rays a step from its stripe of the ray dataset with a
numpy stream seeded [seed, rank] and a torch stream of its own; the step
all-reduces the grads (and the loss) once, before the clip, so that every
rank takes the same Adam step; the consist batch is drawn from a stream
every rank shares; eval renders and the rematch's ordered pairs are striped
over the ranks and gathered, so the metrics and tables are the same on
every rank; the primary's resumed state and tables go to every rank; only
the primary writes checkpoints, logs, tables, images and TensorBoard
events.  A single process without a process group keeps the one-card
path, bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from lushnerf_torch.config import Config
from lushnerf_torch.data.freq_mask import get_masks_for_images
from lushnerf_torch.data.rays import RayDataset, build_ray_dataset
from lushnerf_torch.matcher.api import (
    GridStubMatcher,
    GroundTruthMatcher,
    MatchTables,
    build_match_tables,
    load_gt_depths,
    match_pairs,
)
from lushnerf_torch.models.lushnerf import (
    LushConfig,
    LushNeRF,
    forward_kernel,
    forward_naive,
    render_image,
    render_warped_view,
    resolve_device,
)
from lushnerf_torch.ops.fused import build, nerf_mlp
from lushnerf_torch.parallel import distributed as dist
from lushnerf_torch.parallel.mesh import check_mesh_shape
from lushnerf_torch.train import checkpoint as ckpt_lib
from lushnerf_torch.train.consistency import render_aligned_pixels
from lushnerf_torch.train.losses import (
    CONSIST_WEIGHT,
    consistency_loss,
    mse2psnr,
    photometric_loss,
)
from lushnerf_torch.train.schedule import consist_active, consist_in_loss, stage_for_iter
from lushnerf_torch.utils import lpips as lpips_lib
from lushnerf_torch.utils.images import write_png
from lushnerf_torch.utils.metrics import compute_img_metric

STAGES = ("naive", "kernel", "allkernel")


def make_optimizer(cfg, model: LushNeRF) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, as optax.adam) over every parameter
    once (the aliased RBK modules are shared), with the learning rate
    lrate * 0.1^(count / (lrate_decay * 1000)) where count is the number of
    updates before this one: the scheduler steps after the optimizer."""
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lrate, betas=(0.9, 0.999), eps=1e-8)
    decay = cfg.lrate_decay * 1000.0
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: 0.1 ** (count / decay))
    return opt, sched


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the grads in place as optax.clip_by_global_norm does: unchanged
    when their global norm is below max_norm, else g / norm * max_norm (no
    epsilon, unlike torch.nn.utils.clip_grad_norm_).  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def loss_fn(
    model: LushNeRF,
    lush_cfg: LushConfig,
    H: int,
    W: int,
    focal,
    batch: Dict[str, torch.Tensor],
    stage: str,
    generator: Optional[torch.Generator] = None,
    rand_override: Optional[Dict[str, Any]] = None,
    consist: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, mse) of one stage's forward: the photometric loss, and outside
    the naive stage the optional terms rbk_anchor_reg * drift,
    rbk_spread_l1 * spread and snd_l1 * mean(noise).  With a consist batch
    (keys K [3, 3], poses [V, 3, 4], align_pix [V, n, 2], certainty [V, n],
    weight, threshold: `Trainer._sample_consist_batch`) the CTE term
    weight * consistency_loss(aligned render) is added (run_lushnerf.py:
    646-659), weight 0 included."""
    cfg = lush_cfg
    if stage == "naive":
        out = forward_naive(model, cfg, H, W, focal, batch["rays"], generator, rand_override)
    else:
        fq = batch["fq_mask"] if stage == "kernel" else None
        out = forward_kernel(
            model, cfg, H, W, focal, batch["rays"], batch["images_idx"].reshape(-1),
            generator, fq_mask=fq, rand_override=rand_override,
        )
    loss, mse = photometric_loss(out["rgb_blur"], out["rgb0_blur"], batch["rgbs"])
    if stage != "naive" and cfg.rbk_anchor_reg > 0.0:
        loss = loss + cfg.rbk_anchor_reg * out["rbk_drift"]
    if stage != "naive" and cfg.rbk_spread_l1 > 0.0:
        loss = loss + cfg.rbk_spread_l1 * out["rbk_spread"]
    if stage != "naive" and cfg.snd_l1 > 0.0 and cfg.use_snd:
        loss = loss + cfg.snd_l1 * torch.mean(out["rgb_noise"])
    if consist is not None:
        rgb_align = render_aligned_pixels(model, cfg, H, W, consist["K"], consist["poses"],
                                          consist["align_pix"])
        closs = consistency_loss(rgb_align, consist["certainty"], consist["threshold"])
        loss = loss + consist["weight"] * closs
    return loss, mse


def float64_copy(model: LushNeRF, lush_cfg: LushConfig, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[LushNeRF, LushConfig, Dict[str, torch.Tensor]]:
    """A float64 reference of one step: a float64 copy of the model, the
    config on the plain torch path (`mlp_backend="torch"`: the fused
    kernels run f32 only and refuse f64) and the batch's floating tensors
    in float64 (indices and masks as they are).  `loss_fn` on the three
    gives the step's loss and grads in f64, against which an f32 step's
    rounding is measured."""
    model64 = copy.deepcopy(model).double()
    model64.zero_grad(set_to_none=True)
    render = dataclasses.replace(lush_cfg.render, mlp_backend="torch")
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    return model64, dataclasses.replace(lush_cfg, render=render), batch64


def train_step(
    model: LushNeRF,
    optimizer: torch.optim.Optimizer,
    scheduler,
    lush_cfg: LushConfig,
    H: int,
    W: int,
    focal,
    batch: Dict[str, torch.Tensor],
    stage: str,
    generator: Optional[torch.Generator] = None,
    rand_override: Optional[Dict[str, Any]] = None,
    grad_clip_norm: float = 0.0,
    consist: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update for stage 'naive', 'kernel' or 'allkernel', with the CTE
    term when a consist batch is given (`loss_fn`).  Returns the detached
    (loss, mse) on the device (no host sync).  A parameter that the stage
    does not reach gets a zero grad, so Adam updates it as optax does (its
    moments decay).  Under a process group each rank passes its share of
    the global batch: the grads, the loss and the mse are averaged over the
    ranks in one all-reduce, before the clip (optax clips the global
    gradient), so every rank takes the same step."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    optimizer.zero_grad(set_to_none=True)
    loss, mse = loss_fn(model, lush_cfg, H, W, focal, batch, stage, generator, rand_override,
                        consist)
    loss.backward()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    loss, mse = loss.detach(), mse.detach()
    if dist.in_group():
        loss, mse = loss.clone(), mse.clone()
        dist.all_reduce_mean_([p.grad for p in params] + [loss, mse])
    if grad_clip_norm > 0.0:
        clip_by_global_norm_(params, grad_clip_norm)
    optimizer.step()
    scheduler.step()
    return loss, mse


def to8(x: torch.Tensor) -> np.ndarray:
    """[0, 1] floats -> uint8 on the host, as numpy's
    (255 * clip(x, 0, 1)).astype(uint8) rounds them (toward zero)."""
    return (255 * x.clamp(0, 1)).to(torch.uint8).cpu().numpy()


def area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of an area mean along one axis, as cv2's
    INTER_AREA reduction draws them (computeResizeAreaTab, resize.cpp):
    output cell d covers [d s, (d + 1) s) of the input, s = src / dst, and
    a pixel it covers in part is weighed by the part it covers.  When dst
    divides src, every cell is the mean of a block of s pixels."""
    scale = 1.0 / (dst / src)  # as cv2 forms it from the inverse scale
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = (s1 - f1) / cell
        w[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] = min(f2 - s2, 1.0, cell) / cell
    return w


def area_resize(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, H, W, C] f32 -> [N, h, w, C] by cv2's INTER_AREA reduction
    (h <= H, w <= W), its weights applied along x then y in f64."""
    wx = torch.from_numpy(area_weights(images.shape[2], w)).to(images.device)
    wy = torch.from_numpy(area_weights(images.shape[1], h)).to(images.device)
    out = torch.einsum("xw,nhwc->nhxc", wx, images.double())
    return torch.einsum("yh,nhxc->nyxc", wy, out).float()


class Trainer:
    def __init__(self, cfg: Config, data: Optional[Dict[str, Any]] = None,
                 matcher: Optional[Any] = None, device: str | torch.device = "cuda"):
        """cfg: full config.  data: optional injected dataset (tests,
        synthetic scenes): dict with images [N,H,W,3] float32, poses
        [N,3,4], bds [N,2], render_poses [P,3,4], hwf (H, W, focal); else
        the LLFF scene at cfg.datadir is read.  matcher: optional injected
        matcher for the rematch (overrides cfg.matcher).  device: where the
        model, the ray dataset and every step run ('cuda' unless the caller
        asks for the CPU; under a process group, the rank's card).
        cfg.mesh_shape must be empty or cover the world exactly."""
        self.cfg = cfg
        self._injected = data
        self._matcher = matcher
        self.device = resolve_device(device)
        self.rank, self.world = dist.process_index(), dist.process_count()
        check_mesh_shape(cfg.mesh_shape, self.world)
        self._setup_done = False

    def _say(self, *args):
        """print, on the primary only."""
        if self.rank == 0:
            print(*args)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def setup(self):
        cfg = self.cfg
        if self._injected is not None:
            d = self._injected
            self.images = np.asarray(d["images"], np.float32)
            self.poses = np.asarray(d["poses"], np.float32)
            self.bds = np.asarray(d["bds"], np.float32)
            self.render_poses = np.asarray(d["render_poses"], np.float32)
            H, W, focal = d["hwf"]
        else:
            from lushnerf_torch.data.llff import DEFAULT_BD_FACTOR, load_llff_data

            data = load_llff_data(
                cfg.datadir,
                cfg.factor,
                recenter=True,
                bd_factor=DEFAULT_BD_FACTOR,
                spherify=cfg.spherify,
                path_epi=cfg.render_epi,
                gamma=cfg.scaleup_gamma,
                clahe=cfg.scaleup_clahe,
                render_focuspoint_scale=cfg.render_focuspoint_scale,
                render_radius_scale=cfg.render_radius_scale,
            )
            self.images = data.images
            self.poses = data.poses[:, :3, :4]
            self.bds = data.bds
            self.render_poses = data.render_poses[:, :3, :4]
            hwf = data.poses[0, :3, -1]
            H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])

        self.H, self.W, self.focal = int(H), int(W), float(focal)
        self.K = np.array(
            [[self.focal, 0, 0.5 * self.W], [0, self.focal, 0.5 * self.H], [0, 0, 1]],
            np.float32,
        )

        # render_factor: downsampled eval renders, with the intrinsics
        # scaled too so the render covers the full frame (as lushnerf_tpu;
        # the reference's render_path halves H/W only, cropping the view)
        rf = cfg.render_factor
        if rf and rf > 1:
            self.H_eval, self.W_eval = self.H // rf, self.W // rf
            self.K_eval = (self.K / rf).astype(np.float32)
            self.K_eval[2, 2] = 1.0
        else:
            self.H_eval, self.W_eval, self.K_eval = self.H, self.W, self.K

        n = self.images.shape[0]
        self.i_test = np.arange(n)[:: cfg.llffhold]
        self.i_train = np.array([i for i in range(n) if i not in set(self.i_test)])

        if cfg.no_ndc:
            self.near = float(self.bds.min() * 0.9)
            self.far = float(self.bds.max() * 1.0)
        else:
            self.near, self.far = 0.0, 1.0

        cfg.num_images = n
        self.lush_cfg: LushConfig = cfg.lush_config(self.near, self.far)

        # frequency masks over uint8 images (run_lushnerf.py:282-283)
        images_u8 = (self.images * 255).astype(np.uint8)
        self.frequency_masks = get_masks_for_images(images_u8, radius=cfg.fq_threshold,
                                                    device=self.device)

        # optional training-image downsample (run_lushnerf.py:542-553):
        # rays come from scaled intrinsics; NDC/forward keep the original
        # H, W, focal.
        images_train = self.images[self.i_train]
        fq_train = self.frequency_masks[self.i_train]
        k_train = self.K
        if cfg.datadownsample > 0:
            from lushnerf_torch.data import need

            cv2 = need("cv2")
            s = 1.0 / cfg.datadownsample
            images_train = np.stack(
                [cv2.resize(im, None, None, s, s, cv2.INTER_AREA) for im in images_train]
            )
            hei, wid = images_train.shape[1:3]
            fq_train = np.stack(
                [cv2.resize(m, (wid, hei), interpolation=cv2.INTER_NEAREST) for m in fq_train]
            )
            k_train = np.array(
                [
                    [self.K[0, 0] * wid / self.W, 0, self.K[0, 2] * wid / self.W],
                    [0, self.K[1, 1] * hei / self.H, self.K[1, 2] * hei / self.H],
                    [0, 0, 1],
                ],
                np.float32,
            )

        # each rank keeps every world-th ray, sliced on the host before the
        # rays reach the card, and draws N_rand / world of them a step; the
        # global batch stays N_rand (lushnerf_tpu's trainer :180-193)
        if cfg.N_rand % self.world:
            raise ValueError(f"N_rand={cfg.N_rand} must divide by the world of {self.world} "
                             "processes")
        self.local_n_rand = cfg.N_rand // self.world
        dataset = build_ray_dataset(
            images_train,
            self.poses[self.i_train],
            k_train,
            fq_train,
            np.arange(n)[self.i_train],
            device=self.device if self.world == 1 else "cpu",
        )
        self.dataset: RayDataset = dist.shard_dataset(dataset, self.rank, self.world, self.device)
        # the batches' permutations: the JAX trainer's numpy stream, one a
        # rank ([seed, rank], as a JAX process's)
        self.np_rng = np.random.default_rng([cfg.seed, self.rank] if self.world > 1 else cfg.seed)
        # the consist batches' anchors and columns: a stream of their own,
        # the same on every rank (the consist batch is every rank's)
        self.consist_rng = np.random.default_rng([cfg.seed, 7919])
        self.dataset.shuffle(self.np_rng)
        # the steps' draws (stratified samples, density noise), one stream a
        # rank; a world of 1 keeps cfg.seed
        seed = cfg.seed if self.world == 1 else int(
            np.random.SeedSequence([cfg.seed, self.rank]).generate_state(1)[0])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.world > 1 and self.device.type == "cuda" and \
                self.lush_cfg.render.mlp_backend == "cuda":
            # the primary runs nvcc on the kernels' sources while the other
            # ranks wait, then each loads the libraries (a rank on a host
            # without them builds its own)
            if self.rank == 0:
                build.build_all(nerf_mlp.SOURCES)
            dist.barrier()

        self.model = LushNeRF(self.lush_cfg, seed=cfg.seed, device=self.device)
        self.optimizer, self.scheduler = make_optimizer(cfg, self.model)
        self.start_step = 0

        # resume (run_lushnerf.py:374-389)
        self.exp_dir = Path(cfg.basedir) / cfg.expname
        ckpt_path = cfg.ft_path or ckpt_lib.latest_checkpoint(self.exp_dir)
        if ckpt_path and not cfg.no_reload:
            if str(ckpt_path).endswith(".tar"):
                # reference-format checkpoint (run_lushnerf.py:687-694): the
                # weights import, the optimizer restarts, as lushnerf_tpu's
                from lushnerf_torch.convert import load_reference_checkpoint

                self.start_step, state = load_reference_checkpoint(ckpt_path)
                self.model.load_state_dict(state, strict=True)
            else:
                self.start_step = ckpt_lib.load_checkpoint(
                    ckpt_path, self.model, self.optimizer, self.scheduler
                )
            self._say(f"Resumed from {ckpt_path} at step {self.start_step}")
        if self.world > 1:
            self._sync_state()
        self.step = self.start_step  # the last iteration trained
        self._setup_cte(n)

        self.metrics_file = self.exp_dir / "test_metrics.txt"
        self.log_file = self.exp_dir / "scalars.jsonl"
        # TensorBoard events at <tbdir>/<expname> (run_lushnerf.py:312);
        # tbdir='' disables.  The primary writes every file.
        self.tb = None
        if self.rank == 0:
            self.exp_dir.mkdir(parents=True, exist_ok=True)
            if cfg.tbdir:
                from lushnerf_torch.utils.tb_writer import SummaryWriter

                self.tb = SummaryWriter(Path(cfg.tbdir) / cfg.expname)
            (self.exp_dir / "args.txt").write_text(
                "\n".join(f"{k} = {getattr(cfg, k)}" for k in sorted(cfg.field_names()))
            )
        self._setup_done = True

    def _sync_state(self):
        """Every rank takes the primary's step, model, Adam and scheduler
        state (lushnerf_tpu's trainer :240-250): checkpoints are the
        primary's, and another host may hold none.  The state goes as
        torch.save bytes and is loaded with load_state_dict, whose writes
        into the Parameters bump their versions, on which the kernels'
        weight packs key; a rank that resumed nothing has no Adam state of
        its own to write into."""
        payload = None
        if self.rank == 0:
            buf = io.BytesIO()
            torch.save(ckpt_lib.state_of(self.start_step, self.model, self.optimizer,
                                         self.scheduler), buf)
            payload = buf.getvalue()
        payload = dist.broadcast_from_primary(payload)
        if self.rank != 0:
            state = torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True)
            self.start_step = ckpt_lib.restore(state, self.model, self.optimizer, self.scheduler)

    def _setup_cte(self, n: int):
        """The CTE state: match tables (match_table_path, else zeros of 1024
        columns; on resume the newest match_tables_NNNNNN.npz at or below
        the step, which the reference never saves: it restarts with zero
        tables, run_lushnerf.py:374-389), the consist batch's constant
        tensors, and the matcher of cfg.matcher unless one was injected."""
        cfg = self.cfg
        if cfg.match_table_path:
            self.match_tables = MatchTables.load(cfg.match_table_path)
        else:
            self.match_tables = MatchTables.zeros(len(self.i_train), 1024)
            if self.start_step > 0:
                persisted = [p for p in sorted(self.exp_dir.glob("match_tables_*.npz"))
                             if int(p.stem.split("_")[-1]) <= self.start_step]
                if persisted:
                    self.match_tables = MatchTables.load(persisted[-1])
                    self._say(f"Reloaded CTE match tables from {persisted[-1]}")
        if self.world > 1:
            # the primary's tables on every rank (lushnerf_tpu's trainer
            # :274-290): only its basedir holds them; their shape travels in
            # the pickle, ahead of the values
            kpts, cert = dist.broadcast_from_primary((self.match_tables.kpts,
                                                      self.match_tables.certainty))
            self.match_tables = MatchTables(kpts, cert)
        self._consist_K = torch.from_numpy(self.K).to(self.device)
        self._consist_poses = torch.from_numpy(
            np.ascontiguousarray(self.poses[self.i_train])).to(self.device)
        if self._matcher is not None:
            return
        if cfg.matcher == "stub":
            # identity grid at constant certainty: the whole CTE machinery
            # live without weights (dry runs, scale tests)
            self._matcher = GridStubMatcher()
        elif cfg.matcher == "gt":
            # geometry-exact matches from the scene's depth maps
            # (scripts/make_synthetic_scene.py writes depth/)
            from lushnerf_torch.data.llff import DEFAULT_BD_FACTOR

            depths = load_gt_depths(cfg.datadir, n, self.H, self.W, DEFAULT_BD_FACTOR)
            self._matcher = GroundTruthMatcher(
                poses=self.poses[self.i_train], focal=self.focal, H=self.H, W=self.W,
                depths=depths[self.i_train], n_points=1024,
            )
        elif cfg.matcher == "dkm":
            from lushnerf_torch.matcher.dkm import DKMMatcher

            try:
                self._matcher = DKMMatcher.from_pretrained(cfg.dkm_ckpt_path or None,
                                                           device=self.device)
            except FileNotFoundError as e:
                # no weights: the CTE pass stays live but nothing rematches;
                # precomputed tables still train, zero tables give zero loss
                self._say(
                    f"[CTE] DKM weights unavailable ({e}); "
                    + ("using precomputed match tables"
                       if cfg.match_table_path else
                       "consistency loss inactive until tables are provided")
                )

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def train(self, num_iters: Optional[int] = None):
        """Iterations self.step + 1 .. num_iters (cfg.N_iters when None)."""
        if not self._setup_done:
            self.setup()
        cfg = self.cfg
        last = num_iters if num_iters is not None else cfg.N_iters
        t0 = time.time()
        loss_v = psnr_v = float("nan")
        last_log_t, last_log_i = t0, self.step
        for i in range(self.step + 1, last + 1):
            batch = self.dataset.next_batch(self.local_n_rand, self.np_rng)
            stage = stage_for_iter(
                i, cfg.kernel_start_iter, cfg.allkernel_start_iter, cfg.blur_model_type
            )
            active = consist_active(i, cfg.noisenerf_start_iter)
            loss, mse = train_step(
                self.model, self.optimizer, self.scheduler, self.lush_cfg, self.H, self.W,
                self.focal, batch, stage, self.generator, grad_clip_norm=cfg.grad_clip_norm,
                consist=self._sample_consist_batch(i) if active else None,
            )
            self.step = i

            if active and i % cfg.rematch_interval == 0 and self._matcher is not None:
                self.rematch(i)

            if i % cfg.i_weights == 0 and self.rank == 0:
                ckpt_lib.save_checkpoint(self.exp_dir, i, self.model, self.optimizer,
                                         self.scheduler)

            if i % cfg.i_testset == 0 and i > 0:
                self.eval_testset(i)

            if cfg.debug_nan_check:
                self._guard_finite(i, loss)

            if i % cfg.i_print == 0:  # the loss is the global batch's on every rank
                loss_v = float(loss)
                psnr_v = float(mse2psnr(mse))
            if i % cfg.i_print == 0 and self.rank == 0:
                if not math.isfinite(loss_v):
                    self._report_nonfinite(i, batch, stage)
                now = time.time()
                dt = now - t0
                rays_s = cfg.N_rand * (i - last_log_i) / max(now - last_log_t, 1e-9)
                last_log_t, last_log_i = now, i
                print(f"[TRAIN] Iter: {i} Loss: {loss_v:.5f} PSNR: {psnr_v:.3f} "
                      f"stage: {stage} rays/s: {rays_s:.0f} TIME: {dt:.1f}s")
                with open(self.log_file, "a") as f:
                    f.write(json.dumps({"step": i, "loss": loss_v, "psnr": psnr_v,
                                        "stage": stage, "rays_per_s": rays_s,
                                        "wall_s": dt}) + "\n")
            if self.tb is not None and i % cfg.i_tensorboard == 0:
                self.tb.add_scalar("Train/Loss", float(loss), i)
                self.tb.add_scalar("Train/PSNR", float(mse2psnr(mse)), i)
                self.tb.flush()
        return dict(loss=loss_v, psnr=psnr_v)

    # ------------------------------------------------------------------
    # numerical guards (reference: per-key NaN/Inf prints,
    # models/lushnerf.py:474-478 -- here at i_print cadence always, every
    # step under cfg.debug_nan_check)
    # ------------------------------------------------------------------

    def _guard_finite(self, i: int, loss):
        if not math.isfinite(float(loss)):
            raise FloatingPointError(f"! [Numerical Error] loss non-finite at iter {i}")

    @torch.no_grad()
    def _report_nonfinite(self, i: int, batch, stage: str):
        """Which forward outputs go non-finite (per-key counts), on the
        step's batch with the updated weights and fresh draws."""
        print(f"! [Numerical Error] loss non-finite at iter {i} (stage {stage})")
        cfg = self.lush_cfg
        if stage == "naive":
            out = forward_naive(self.model, cfg, self.H, self.W, self.focal, batch["rays"],
                                self.generator)
        else:
            out = forward_kernel(self.model, cfg, self.H, self.W, self.focal, batch["rays"],
                                 batch["images_idx"].reshape(-1), self.generator)
        for k, v in out.items():
            bad = int(torch.sum(~torch.isfinite(v)))
            if bad:
                print(f"! [Numerical Error] output '{k}': {bad} non-finite values")

    # ------------------------------------------------------------------
    # consistency (CTE)
    # ------------------------------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device, from pinned memory without a
        sync (the caching host allocator keeps the block until the copy is
        done)."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sample_consist_batch(self, i: int) -> Dict[str, Any]:
        """The consist batch of iteration i: an anchor view and
        consist_num_pixels columns drawn from consist_rng (a stream of its
        own, as lushnerf_tpu's), each train view's matched pixels and
        certainties there, and the CTE weight, which applies strictly after
        noisenerf_start_iter (the pass runs at >=, the loss adds at >,
        run_lushnerf.py:629 vs :658)."""
        cfg = self.cfg
        _, align_pix, cert = self.match_tables.sample_anchor(self.consist_rng,
                                                             cfg.consist_num_pixels)
        weight = CONSIST_WEIGHT if consist_in_loss(i, cfg.noisenerf_start_iter) else 0.0
        return {"K": self._consist_K, "poses": self._consist_poses,
                "align_pix": self._upload(align_pix), "certainty": self._upload(cert),
                "weight": weight, "threshold": cfg.consist_threshold}

    def rematch(self, i: int):
        """Match every ordered pair of freshly rendered train views
        (run_lushnerf.py:745-774, without its PNG round trip), at the eval
        resolution, the keypoints then brought to the full resolution;
        saved as match_tables_{i:06d}.npz.  Renders and pairs are striped
        over the ranks and gathered: the tables are the same on every rank,
        each matching 1 / world of the pairs (lushnerf_tpu's trainer
        :584-622)."""
        renders, _, _ = self._render_poses(self.poses[self.i_train])
        self.match_tables = self._build_tables_striped(renders.cpu().numpy())
        if self.H_eval != self.H:
            s = np.array([self.W / self.W_eval, self.H / self.H_eval] * 2, np.float32)
            self.match_tables.kpts *= s
        if self.rank == 0:
            self.match_tables.save(self.exp_dir / f"match_tables_{i:06d}.npz")

    def _build_tables_striped(self, renders: np.ndarray) -> MatchTables:
        """The V x V ordered pairs of renders [V, H, W, 3] matched, every
        world-th pair on each rank and gathered in pair order; with fewer
        pairs than ranks every rank matches them all."""
        V = renders.shape[0]
        pairs = [(k, v) for k in range(V) for v in range(V)]
        if self.world == 1 or len(pairs) < self.world:
            return build_match_tables(self._matcher, renders)
        idxs = dist.stripe_indices(len(pairs), self.rank, self.world)
        kpts, cert = match_pairs(self._matcher, renders, [pairs[j] for j in idxs])
        pad = -(-len(pairs) // self.world) - len(idxs)  # one shape on every rank
        kpts = np.concatenate([kpts, np.zeros((pad, *kpts.shape[1:]), kpts.dtype)])
        cert = np.concatenate([cert, np.zeros((pad, *cert.shape[1:]), cert.dtype)])
        kpts = dist.allgather_stack(kpts, len(pairs))
        cert = dist.allgather_stack(cert, len(pairs))
        P = kpts.shape[1]
        return MatchTables(kpts.reshape(V, V, P, 4), cert.reshape(V, V, P))

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def render_pose(self, c2w):
        """(rgb, noise image, depth) of one pose at the render_factor eval
        resolution, on the device."""
        return render_image(self.model, self.lush_cfg, self.H_eval, self.W_eval, self.K_eval,
                            c2w, ray_chunk=self.cfg.ray_chunk_eval)

    def _render_poses(self, poses):
        """(rgb [N, h, w, 3], noise [N, h, w, 3], depth [N, h, w]) of the poses
        at the eval resolution, the same on every rank: each rank renders
        every world-th pose and the stripes are gathered in pose order."""
        n = len(poses)
        local = torch.zeros((-(-n // self.world), self.H_eval, self.W_eval, 7),
                            device=self.device)
        for j, vi in enumerate(dist.stripe_indices(n, self.rank, self.world)):
            rgb, noise, depth = self.render_pose(poses[vi])
            local[j] = torch.cat([rgb, noise, depth[..., None]], dim=-1)
        out = dist.allgather_stack(local, n)
        return out[..., :3], out[..., 3:6], out[..., 6]

    def eval_testset(self, i: int, save: bool = True):
        """Render all poses, save rgb/noise/blur triplets, compute metrics
        on the test split (run_lushnerf.py:696-743; SSIM computed here
        rather than the reference's hardcoded 0; LPIPS nan, with the reason
        printed, when its weights are not found).  The metrics are the same
        on every rank; the primary writes."""
        out_dir = self.exp_dir / f"testset_{i:06d}"
        if self.rank == 0:
            out_dir.mkdir(parents=True, exist_ok=True)
        rgbs, noises, _ = self._render_poses(self.poses)
        if save and self.rank == 0:
            for vi, (rgb, noise, blur) in enumerate(zip(to8(rgbs), to8(noises), to8(rgbs + noises))):
                write_png(out_dir / f"{vi:03d}.png", rgb)
                write_png(out_dir / f"{vi:03d}_noise.png", noise)
                write_png(out_dir / f"{vi:03d}_blur.png", blur)

        test_rgbs = rgbs[torch.as_tensor(self.i_test, device=rgbs.device)]
        gt = self._gt_at_eval_res(self.i_test)
        test_mse = compute_img_metric(test_rgbs, gt, "mse")
        test_psnr = compute_img_metric(test_rgbs, gt, "psnr")
        test_ssim = compute_img_metric(test_rgbs, gt, "ssim")
        lpips_note = lpips_lib.unavailable_reason()
        if lpips_note is None and lpips_lib.available():
            test_lpips = compute_img_metric(test_rgbs, gt, "lpips")
        else:
            test_lpips = float("nan")
            if lpips_note:
                self._say(f"[eval] {lpips_note}")
        line = (f"iter{i}: MSE:{test_mse:.8f} PSNR:{test_psnr:.8f} "
                f"SSIM:{test_ssim:.8f} LPIPS:{test_lpips:.8f}")
        if self.rank == 0:
            print("**[Evaluation]** " + line)
            with open(self.metrics_file, "a") as f:
                f.write(line + "\n")
        if self.tb is not None:  # Test scalars (run_lushnerf.py:731-734)
            self.tb.add_scalar("Test/MSE", test_mse, i)
            self.tb.add_scalar("Test/PSNR", test_psnr, i)
            self.tb.add_scalar("Test/SSIM", test_ssim, i)
            if math.isfinite(test_lpips):
                self.tb.add_scalar("Test/LPIPS", test_lpips, i)
            self.tb.flush()
        return dict(mse=test_mse, psnr=test_psnr, ssim=test_ssim, lpips=test_lpips)

    def _gt_at_eval_res(self, idx) -> torch.Tensor:
        """GT images for view indices idx on the device, brought to the
        render_factor eval resolution by cv2's area mean (`area_resize`;
        the JAX trainer calls cv2.resize with INTER_AREA)."""
        gt = torch.from_numpy(self.images[idx]).to(self.device)
        if self.H_eval != self.H:
            gt = area_resize(gt, self.H_eval, self.W_eval)
        return gt

    def save_warped_ray_img(self):
        """Render each train view's RBK sub-ray bundle images
        (run_lushnerf.py:426-478, via the working warped renderer); on the
        primary only."""
        out_dir = self.exp_dir / f"warped_ray_img_{self.start_step:06d}"
        if self.rank != 0:
            return out_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        rays_save = []
        for vi in self.i_train:
            rgbs, depths, centre = render_warped_view(
                self.model, self.lush_cfg, self.H, self.W, self.K, self.poses[vi], int(vi),
                self.cfg.ray_chunk_eval,
            )
            rays_save.append(centre.cpu().numpy())
            disp = 1.0 - depths
            disp = disp / disp.amax(dim=(1, 2), keepdim=True).clamp_min(1e-8)
            for wi, (rgb, d) in enumerate(zip(to8(rgbs), to8(disp))):
                write_png(out_dir / f"{vi:03d}_scene_{wi:03d}.png", rgb)
                write_png(out_dir / f"{vi:03d}_scene_{wi:03d}_disp.png", d)
        np.save(out_dir / "rays_warped.npy", np.stack(rays_save))
        return out_dir

    def render_only(self, render_test: bool = False):
        """Render the spiral path (or all poses, with metrics on the test
        split) from the current weights as PNG frames (run_lushnerf.py:
        482-533; the path's mp4 is not written).  The frames are striped
        over the ranks; the primary writes."""
        poses = self.poses if render_test else self.render_poses
        out_dir = self.exp_dir / (
            f"renderonly_{'test' if render_test else 'path'}_{self.start_step:06d}"
        )
        rgbs, _, depths = self._render_poses(poses)
        # disparity images, reference convention (run_lushnerf.py:503-531):
        # disp = 1 - depth (NDC depth in [0,1]), normalized by the global
        # max over all rendered frames
        disps = 1.0 - depths
        disps = to8(disps / disps.max().clamp_min(1e-8))
        names = "{:03d}.png" if render_test else "path_{:03d}.png"
        if self.rank == 0:
            out_dir.mkdir(parents=True, exist_ok=True)
            for vi, rgb in enumerate(to8(rgbs)):
                write_png(out_dir / names.format(vi), rgb)
                write_png(out_dir / names.format(vi).replace(".png", "_disp.png"), disps[vi])
        if render_test:
            # renders are at the eval (render_factor) resolution; the GT too
            test_rgbs = rgbs[torch.as_tensor(self.i_test, device=rgbs.device)]
            gt = self._gt_at_eval_res(self.i_test)
            res = {
                "psnr": compute_img_metric(test_rgbs, gt, "psnr"),
                "ssim": compute_img_metric(test_rgbs, gt, "ssim"),
            }
            if self.rank == 0:
                with open(self.metrics_file, "a") as f:
                    f.write(f"**[Evaluation]** : PSNR:{res['psnr']:.8f} "
                            f"SSIM:{res['ssim']:.8f}\n")
            return res
        return {"frames": len(rgbs)}
