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

The loop adds no host work a step beyond Python: the ray dataset lives on
the device (a batch is an index_select), randomness comes from a device
`torch.Generator`, and the loss reaches the host only at the i_print /
i_tensorboard cadence (every step under debug_nan_check).  CTE (the
cross-view consistency loss) is not ported yet: a run whose iterations
reach noisenerf_start_iter is refused with NotImplementedError.
"""

from __future__ import annotations

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
from lushnerf_torch.models.lushnerf import (
    LushConfig,
    LushNeRF,
    forward_kernel,
    forward_naive,
    render_image,
    render_warped_view,
    resolve_device,
)
from lushnerf_torch.train import checkpoint as ckpt_lib
from lushnerf_torch.train.losses import mse2psnr, photometric_loss
from lushnerf_torch.train.schedule import consist_active, stage_for_iter
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, mse) of one stage's forward: the photometric loss, and outside
    the naive stage the optional terms rbk_anchor_reg * drift,
    rbk_spread_l1 * spread and snd_l1 * mean(noise)."""
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
    return loss, mse


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update for stage 'naive', 'kernel' or 'allkernel'.  Returns the
    detached (loss, mse) on the device (no host sync).  A parameter that the
    stage does not reach gets a zero grad, so Adam updates it as optax does
    (its moments decay)."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    optimizer.zero_grad(set_to_none=True)
    loss, mse = loss_fn(model, lush_cfg, H, W, focal, batch, stage, generator, rand_override)
    loss.backward()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if grad_clip_norm > 0.0:
        clip_by_global_norm_(params, grad_clip_norm)
    optimizer.step()
    scheduler.step()
    return loss.detach(), mse.detach()


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
                 device: str | torch.device = "cuda"):
        """cfg: full config.  data: optional injected dataset (tests,
        synthetic scenes): dict with images [N,H,W,3] float32, poses
        [N,3,4], bds [N,2], render_poses [P,3,4], hwf (H, W, focal); else
        the LLFF scene at cfg.datadir is read.  device: where the model,
        the ray dataset and every step run ('cuda' unless the caller asks
        for the CPU)."""
        self.cfg = cfg
        self._injected = data
        self.device = resolve_device(device)
        self._setup_done = False

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

        self.dataset: RayDataset = build_ray_dataset(
            images_train,
            self.poses[self.i_train],
            k_train,
            fq_train,
            np.arange(n)[self.i_train],
            device=self.device,
        )
        # the batches' permutations: the JAX trainer's numpy stream
        self.np_rng = np.random.default_rng(cfg.seed)
        self.dataset.shuffle(self.np_rng)
        # the steps' draws (stratified samples, density noise)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

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
            print(f"Resumed from {ckpt_path} at step {self.start_step}")
        self.step = self.start_step  # the last iteration trained
        if not (cfg.render_only or cfg.save_warped_ray_img):
            self._check_no_cte(cfg.N_iters)

        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_file = self.exp_dir / "test_metrics.txt"
        self.log_file = self.exp_dir / "scalars.jsonl"
        # TensorBoard events at <tbdir>/<expname> (run_lushnerf.py:312);
        # tbdir='' disables
        self.tb = None
        if cfg.tbdir:
            from lushnerf_torch.utils.tb_writer import SummaryWriter

            self.tb = SummaryWriter(Path(cfg.tbdir) / cfg.expname)
        (self.exp_dir / "args.txt").write_text(
            "\n".join(f"{k} = {getattr(cfg, k)}" for k in sorted(cfg.field_names()))
        )
        self._setup_done = True

    def _check_no_cte(self, last_iter: int):
        """CTE is not ported: refuse a run whose iterations (self.step + 1
        to last_iter) reach noisenerf_start_iter, rather than train them
        without the consistency pass."""
        start = self.cfg.noisenerf_start_iter
        if self.step < last_iter and consist_active(last_iter, start):
            raise NotImplementedError(
                f"lushnerf_torch: iterations {self.step + 1}-{last_iter} reach "
                f"noisenerf_start_iter = {start}, where CTE (the cross-view consistency "
                f"loss) starts, and CTE is not ported yet (it is the port's next slice). "
                f"Train to the iteration before it: --N_iters {start - 1}"
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
        self._check_no_cte(last)
        t0 = time.time()
        loss_v = psnr_v = float("nan")
        last_log_t, last_log_i = t0, self.step
        for i in range(self.step + 1, last + 1):
            batch = self.dataset.next_batch(cfg.N_rand, self.np_rng)
            stage = stage_for_iter(
                i, cfg.kernel_start_iter, cfg.allkernel_start_iter, cfg.blur_model_type
            )
            loss, mse = train_step(
                self.model, self.optimizer, self.scheduler, self.lush_cfg, self.H, self.W,
                self.focal, batch, stage, self.generator, grad_clip_norm=cfg.grad_clip_norm,
            )
            self.step = i

            if i % cfg.i_weights == 0:
                ckpt_lib.save_checkpoint(self.exp_dir, i, self.model, self.optimizer,
                                         self.scheduler)

            if i % cfg.i_testset == 0 and i > 0:
                self.eval_testset(i)

            if cfg.debug_nan_check:
                self._guard_finite(i, loss)

            if i % cfg.i_print == 0:
                loss_v = float(loss)
                psnr_v = float(mse2psnr(mse))
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
    # evaluation
    # ------------------------------------------------------------------

    def render_pose(self, c2w):
        """(rgb, noise image, depth) of one pose at the render_factor eval
        resolution, on the device."""
        return render_image(self.model, self.lush_cfg, self.H_eval, self.W_eval, self.K_eval,
                            c2w, ray_chunk=self.cfg.ray_chunk_eval)

    def _render_poses(self, poses):
        rgbs, noises, depths = zip(*(self.render_pose(p) for p in poses))
        return torch.stack(rgbs), torch.stack(noises), torch.stack(depths)

    def eval_testset(self, i: int, save: bool = True):
        """Render all poses, save rgb/noise/blur triplets, compute metrics
        on the test split (run_lushnerf.py:696-743; SSIM computed here
        rather than the reference's hardcoded 0; LPIPS not ported, so nan)."""
        out_dir = self.exp_dir / f"testset_{i:06d}"
        out_dir.mkdir(parents=True, exist_ok=True)
        rgbs, noises, _ = self._render_poses(self.poses)
        if save:
            for vi, (rgb, noise, blur) in enumerate(zip(to8(rgbs), to8(noises), to8(rgbs + noises))):
                write_png(out_dir / f"{vi:03d}.png", rgb)
                write_png(out_dir / f"{vi:03d}_noise.png", noise)
                write_png(out_dir / f"{vi:03d}_blur.png", blur)

        test_rgbs = rgbs[torch.as_tensor(self.i_test, device=rgbs.device)]
        gt = self._gt_at_eval_res(self.i_test)
        test_mse = compute_img_metric(test_rgbs, gt, "mse")
        test_psnr = compute_img_metric(test_rgbs, gt, "psnr")
        test_ssim = compute_img_metric(test_rgbs, gt, "ssim")
        test_lpips = float("nan")
        print("[eval] LPIPS is not ported to lushnerf_torch; reported as nan")
        line = (f"iter{i}: MSE:{test_mse:.8f} PSNR:{test_psnr:.8f} "
                f"SSIM:{test_ssim:.8f} LPIPS:{test_lpips:.8f}")
        print("**[Evaluation]** " + line)
        with open(self.metrics_file, "a") as f:
            f.write(line + "\n")
        if self.tb is not None:  # Test scalars (run_lushnerf.py:731-734)
            self.tb.add_scalar("Test/MSE", test_mse, i)
            self.tb.add_scalar("Test/PSNR", test_psnr, i)
            self.tb.add_scalar("Test/SSIM", test_ssim, i)
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
        (run_lushnerf.py:426-478, via the working warped renderer)."""
        out_dir = self.exp_dir / f"warped_ray_img_{self.start_step:06d}"
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
        482-533; the path's mp4 is not written)."""
        poses = self.poses if render_test else self.render_poses
        out_dir = self.exp_dir / (
            f"renderonly_{'test' if render_test else 'path'}_{self.start_step:06d}"
        )
        out_dir.mkdir(parents=True, exist_ok=True)
        rgbs, _, depths = self._render_poses(poses)
        # disparity images, reference convention (run_lushnerf.py:503-531):
        # disp = 1 - depth (NDC depth in [0,1]), normalized by the global
        # max over all rendered frames
        disps = 1.0 - depths
        disps = to8(disps / disps.max().clamp_min(1e-8))
        names = "{:03d}.png" if render_test else "path_{:03d}.png"
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
            with open(self.metrics_file, "a") as f:
                f.write(f"**[Evaluation]** : PSNR:{res['psnr']:.8f} SSIM:{res['ssim']:.8f}\n")
            return res
        return {"frames": len(rgbs)}
