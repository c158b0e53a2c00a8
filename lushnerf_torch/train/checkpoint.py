"""Checkpoint / resume.

Reference behavior (run_lushnerf.py:374-389, 687-694): save
{global_step, model state, optimizer state} every i_weights iters to
`<basedir>/<expname>/NNNNNN.tar`; on startup auto-resume from the
lexicographically-last checkpoint unless --no_reload; --ft_path overrides.

Here, as in lushnerf_tpu/train/checkpoint.py, the files are `NNNNNN.ckpt`
in the same directory: `torch.save` of the global step, the model's state
dict, and the Adam and learning-rate scheduler state, read back with
`torch.load(weights_only=True)`.  A reference `.tar` is read by
`lushnerf_torch.convert.load_reference_checkpoint` (weights only).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

CKPT_RE = re.compile(r"^(\d{6})\.ckpt$")


def save_checkpoint(exp_dir: str | Path, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, scheduler) -> Path:
    """Writes `{step:06d}.ckpt` (through a temporary file, so a run cut
    while writing leaves no partial checkpoint for the next to resume)."""
    exp_dir = Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    path = exp_dir / f"{step:06d}.ckpt"
    tmp = path.with_suffix(".ckpt.tmp")
    torch.save(state_of(step, model, optimizer, scheduler), tmp)
    os.replace(tmp, path)
    return path


def state_of(step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             scheduler) -> dict:
    """What a checkpoint holds: the global step, the model's state dict, the
    Adam and the scheduler state."""
    return {
        "global_step": int(step),
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
    }


def restore(state: dict, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
            scheduler) -> int:
    """Loads a `state_of` dict into the model, Adam and the scheduler (shapes
    must match); returns its global step."""
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    return int(state["global_step"])


def latest_checkpoint(exp_dir: str | Path) -> Optional[Path]:
    exp_dir = Path(exp_dir)
    if not exp_dir.exists():
        return None
    ckpts = sorted(f for f in os.listdir(exp_dir) if CKPT_RE.match(f))
    return exp_dir / ckpts[-1] if ckpts else None


def load_checkpoint(path: str | Path, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler) -> int:
    """Restores the model, Adam and the scheduler in place (shapes must
    match); returns the global step.  Read on the CPU: the model and the
    optimizer put each tensor on its parameter's device (Adam keeps its
    step counts on the CPU)."""
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    return restore(state, model, optimizer, scheduler)
