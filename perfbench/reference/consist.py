"""LuSh-NeRF's training step in the allkernel stage with the multi-view
consistency (CTE) term, in plain PyTorch: the yardstick of the consist
iterations.

A transcription of the published step (quzefan/LuSh-NeRF,
`run_lushnerf.py:629-661`, `models/lushnerf.py:949-988`,
`utils/run_lushnerf_helpers.py:665-688`) on top of `nerf.kernel_loss`:
  * the allkernel stage is the kernel stage's loss with every ray's
    sub-rays carrying their gradient (no frequency mask);
  * the aligned render: in every train view, the pixels matched to the
    anchor's columns (coordinates clamped to the image and floored), each
    pixel's centre ray through the sharp branch (no blur kernel, no noise
    head), sampled as at eval (no jitter, no density noise, deterministic
    importance samples) but without the near-plane mask, the fine rgb
    before the tone map;
  * the CTE loss: a view's entry is confident where its certainty reaches
    the threshold; each pixel's mean over its confident views (0 where
    none is); the L1 of each confident entry against its pixel's mean,
    over the number of confident entries (at least 1);
  * the step's loss adds weight x that (weight 1e-2 after
    noisenerf_start_iter, 0 at it).
The steps run from the weights and Adam's state they are given, with Adam
(b1 0.9, b2 0.999, eps 1e-8) at the configuration's decayed learning rate.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.reference import nerf
from perfbench.reference.precision import float32_products, linear_fn
from perfbench.reference.train import adam_update


def aligned_rgb(p: nerf.Params, cfg: dict, H: int, W: int, K, poses, align_pix, lin):
    """The fine rgb [V, n, 3] before the tone map of each view's matched
    pixels align_pix [V, n, 2] (x, y), poses [V, 3, 4]."""
    V, n = align_pix.shape[:2]
    ii = torch.floor(torch.clamp(align_pix[..., 0], 0, W - 1)).reshape(-1)
    jj = torch.floor(torch.clamp(align_pix[..., 1], 0, H - 1)).reshape(-1)
    c2w = poses[:, None].expand(V, n, 3, 4).reshape(V * n, 3, 4)
    with torch.no_grad():
        o, d = nerf.pixel_rays(H, W, K, c2w, ii, jj)
    o_n, d_n, vd = nerf.prepare(cfg, H, W, float(K[0, 0]), o, d)
    rgb, _ = nerf.scene(p, cfg, o_n, d_n, vd, lin)
    return rgb.reshape(V, n, 3)


def cte_loss(rgb, certainty, threshold: float):
    mask = (certainty >= threshold).to(rgb.dtype)[..., None]  # [V, n, 1]
    mean = torch.sum(rgb * mask, dim=0) / torch.clamp(mask.sum(dim=0), min=1.0)
    return torch.sum(torch.abs(rgb - mean[None]) * mask) / torch.clamp(mask.sum(), min=1.0)


def step_loss(p: nerf.Params, cfg: dict, H: int, W: int, focal: float, s: dict, lin, lin_other):
    """(loss, CTE term, aligned rgb) of one allkernel + consist step `s`:
    rays, idx, rgbs, draws and consist (K, poses, align_pix, certainty,
    weight, threshold)."""
    fq = torch.ones(len(s["idx"]), dtype=torch.bool, device=s["idx"].device)
    loss = nerf.kernel_loss(p, cfg, H, W, focal, s["rays"], s["idx"], fq, s["rgbs"], s["draws"],
                            lin, lin_other)
    c = s["consist"]
    rgb = aligned_rgb(p, cfg, H, W, c["K"], c["poses"], c["align_pix"], lin)
    term = cte_loss(rgb, c["certainty"], c["threshold"])
    return loss + c["weight"] * term, term, rgb


def cte_pass(weights: Dict[str, torch.Tensor], cfg: dict, scene: dict, consist: dict,
             precision: Dict[str, str], leaves: List[str]) -> dict:
    """The CTE term alone (the aligned render, then the CTE loss) of
    consist (K, poses, align_pix, certainty, threshold) at `weights`:
    {term, grad: its gradient over `leaves`}."""
    H, W, _ = scene["hwf"]
    lin = linear_fn(precision["lin"])
    p = {k: v.detach().float().clone().requires_grad_(k in leaves) for k, v in weights.items()}
    with float32_products():
        rgb = aligned_rgb(p, cfg, H, W, consist["K"], consist["poses"], consist["align_pix"], lin)
        term = cte_loss(rgb, consist["certainty"], consist["threshold"])
        grads = torch.autograd.grad(term, [p[k] for k in leaves], allow_unused=True)
    return {"term": float(term.detach()),
            "grad": {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(leaves, grads)}}


def reference_steps(weights: Dict[str, torch.Tensor], adam: dict, cfg: dict, scene: dict,
                    steps: List[dict], precision: Dict[str, str], lr_count: int):
    """Runs the steps from `weights` and Adam's state `adam` ({"t": updates
    made, ("m", leaf), ("v", leaf)}: the reference's own names), the
    learning rate at lr_count updates before the first.  Returns {losses,
    terms (the CTE terms), grad (the first step's), rgb (the first step's
    aligned render), after (the weights after the last step)}."""
    H, W, focal = scene["hwf"]
    lin, lin_other = linear_fn(precision["lin"]), linear_fn(precision["lin_other"])
    p = {k: v.detach().float().clone() for k, v in weights.items()}
    state = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in adam.items()}
    out = {"losses": [], "terms": [], "grad": None, "rgb": None}
    decay = cfg["lrate_decay"] * 1000.0
    with float32_products():
        for n, s in enumerate(steps):
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss, term, rgb = step_loss(leaves, cfg, H, W, focal, s, lin, lin_other)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(leaves.items(), grads)}
            if out["grad"] is None:
                out["grad"], out["rgb"] = grads, rgb.detach()
            out["losses"].append(float(loss.detach()))
            out["terms"].append(float(term.detach()))
            adam_update(p, grads, state, cfg["lrate"] * 0.1 ** ((lr_count + n) / decay))
    out["after"] = p
    return out
