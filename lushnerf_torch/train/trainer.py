"""One training step of LuSh-NeRF: the staged loss, Adam with the
reference's exponential learning-rate decay, and the optional global-norm
clip (the step of lushnerf_tpu's `Trainer._loss_fn` / `step_fn`).

    opt, sched = make_optimizer(cfg, model)
    loss, mse = train_step(model, opt, sched, cfg.lush_config(), H, W, focal,
                           batch, stage, generator, grad_clip_norm=cfg.grad_clip_norm)

`batch` holds tensors on the model's device: rays [N, 3, 2], rgbs [N, 3],
images_idx [N] or [N, 1] (int), fq_mask [N] (bool).  The data pipeline,
the training loop, eval and checkpoints are not here yet.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from lushnerf_torch.models.lushnerf import LushConfig, LushNeRF, forward_kernel, forward_naive
from lushnerf_torch.train.losses import photometric_loss

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
