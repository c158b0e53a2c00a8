"""The reference's training steps and the judgement of the program's
batches.

The program's batches are its own output (which pixels its data pipeline
drew): the reference reads each row only to find its pixel, checks that the
row is that pixel's ray, colour and frequency-mask bit, and then builds the
row again from the scene itself.  The steps then run from the benchmark's
weights and draws, with Adam (b1 0.9, b2 0.999, eps 1e-8) at the
configuration's decayed learning rate.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import nerf
from perfbench.reference.precision import float32_products, linear_fn

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
MASK_LEVEL = 48.0  # the frequency mask's threshold on the normalised magnitude
RAY_ATOL = 1e-5  # two float32 evaluations of one pixel's ray
PIXEL_ATOL = 1e-2  # a row's direction lands this close to a pixel centre


def intrinsics(H: int, W: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)


def frequency_levels(images: np.ndarray, radius: int, device) -> torch.Tensor:
    """The normalised low-passed magnitude [N, H, W] (float64) of uint8 RGB
    images [N, H, W, 3], as the reference's frequency_mask computes it:
    OpenCV's grey, a DFT, a square window of +-radius around the centred
    zero frequency, the inverse DFT's magnitude min-max normalised to
    [0, 255].  The mask is level > 48."""
    x = images.astype(np.int64)
    grey = (19596 * x[..., 0] + 38470 * x[..., 1] + 7470 * x[..., 2] + 32768) >> 16
    rows, cols = grey.shape[-2:]
    win = np.zeros((rows, cols), np.float64)
    win[rows // 2 - radius: rows // 2 + radius, cols // 2 - radius: cols // 2 + radius] = 1.0
    g = torch.as_tensor(grey, device=device).to(torch.float64)
    spec = torch.fft.fft2(g) * torch.as_tensor(np.fft.ifftshift(win), device=device)
    mag = torch.fft.ifft2(spec).abs()
    lo = mag.amin(dim=(-2, -1), keepdim=True)
    hi = mag.amax(dim=(-2, -1), keepdim=True)
    return (mag - lo) / (hi - lo) * 255.0


def judge_batch(batch: Dict[str, torch.Tensor], scene: dict, levels: torch.Tensor,
                train_views: np.ndarray) -> dict:
    """Finds each row's pixel from its view and ray direction, and counts
    the rows that are not that pixel's ray, colour and mask bit, or that
    repeat a pixel.  Returns the count ("wrong") and the reference's own
    rows: rays, idx, fq, rgbs."""
    dev = levels.device
    H, W, focal = scene["hwf"]
    K = torch.as_tensor(intrinsics(H, W, focal), device=dev)
    idx = batch["images_idx"].reshape(-1).long()
    poses = torch.as_tensor(scene["poses"], device=dev)[idx]
    rays = batch["rays"].float()
    d_cam = torch.einsum("nck,nc->nk", poses[:, :3, :3], rays[..., 1])  # R^T d
    ii = d_cam[:, 0] / -d_cam[:, 2] * K[0, 0] + K[0, 2] - nerf.HALF_PIX
    jj = -(d_cam[:, 1] / -d_cam[:, 2]) * K[1, 1] + K[1, 2] - nerf.HALF_PIX
    ic, jc = torch.round(ii).long(), torch.round(jj).long()
    is_train = torch.as_tensor(np.isin(idx.cpu().numpy(), train_views), device=dev)
    on_grid = ((ii - ic).abs() < PIXEL_ATOL) & ((jj - jc).abs() < PIXEL_ATOL) & \
        (ic >= 0) & (ic < W) & (jc >= 0) & (jc < H) & is_train
    ic, jc = ic.clamp(0, W - 1), jc.clamp(0, H - 1)
    o, d = nerf.pixel_rays(H, W, K, poses, ic.float(), jc.float())
    ref_rays = torch.stack([o, d], dim=-1)
    rgbs = torch.as_tensor(scene["images"], device=dev)[idx, jc, ic]
    slot = np.full(int(idx.max()) + 1, 0)
    slot[train_views[train_views <= idx.max().item()]] = np.arange(
        int((train_views <= idx.max().item()).sum()))
    lev = levels[torch.as_tensor(slot, device=dev)[idx], jc, ic]
    fq = lev > MASK_LEVEL
    fq_ok = (batch["fq_mask"].reshape(-1).bool() == fq) | ((lev - MASK_LEVEL).abs() < 1e-6)
    good = on_grid & fq_ok & ((rays - ref_rays).abs().amax(dim=(1, 2)) <= RAY_ATOL) & \
        (batch["rgbs"].float() == rgbs).all(dim=1)
    pixel = idx * (H * W) + jc * W + ic
    repeats = len(pixel) - len(torch.unique(pixel))
    return {"wrong": int((~good).sum()) + repeats, "rays": ref_rays, "idx": idx, "fq": fq,
            "rgbs": rgbs}


def adam_update(p: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
                lr: float) -> None:
    t = state["t"] = state.get("t", 0) + 1
    b1, b2 = BETAS
    for k, g in grads.items():
        m = state.setdefault(("m", k), torch.zeros_like(g))
        v = state.setdefault(("v", k), torch.zeros_like(g))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v / (1 - b2 ** t)).sqrt_().add_(ADAM_EPS)
        p[k] = p[k] - lr / (1 - b1 ** t) * m / denom


def _cast(x, dtype):
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


def reference_steps(weights: Dict[str, torch.Tensor], cfg: dict, scene: dict,
                    steps: List[dict], precision: Dict[str, str],
                    half_batch: bool = False, dtype: torch.dtype = torch.float32):
    """Runs the steps (each: rays, idx, fq, rgbs, draws) from `weights`.
    Returns (losses, the first step's grads, the weights after the last
    step).  half_batch (a fault) takes each loss's colour terms over the
    first half of the rows; dtype float64 gives a witness of the float32
    reference's own rounding."""
    H, W, focal = scene["hwf"]
    lin, lin_other = linear_fn(precision["lin"]), linear_fn(precision["lin_other"])
    p = {k: v.detach().to(dtype) for k, v in weights.items()}
    steps = [_cast(s, dtype) for s in steps]
    state, losses, first = {}, [], None
    decay = cfg["lrate_decay"] * 1000.0
    with float32_products():
        for n, s in enumerate(steps):
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            rows: Optional[int] = len(s["idx"]) // 2 if half_batch else None
            loss = nerf.kernel_loss(leaves, cfg, H, W, focal, s["rays"], s["idx"], s["fq"],
                                    s["rgbs"], s["draws"], lin, lin_other, rows=rows)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(leaves.items(), grads)}
            if first is None:
                first = grads
            losses.append(float(loss.detach()))
            adam_update(p, grads, state, cfg["lrate"] * 0.1 ** (n / decay))
    return losses, _cast(first, torch.float32), _cast(p, torch.float32)
