"""Staged training schedule.

The reference gates its computation graph on the iteration count
(run_lushnerf.py:625-661, models/lushnerf.py:636-643):
  i <  kernel_start_iter                     -> 'naive'   (no blur kernel)
  kernel_start <= i < allkernel_start_iter   -> 'kernel'  (fq-mask gating on)
  i >= allkernel_start_iter                  -> 'allkernel' (all pixels)
and the consistency (CTE) pass/loss activates at i >= / > noisenerf_start
(computed when >=, added to the loss when >, :629,:658 -- both honored).
"""

from __future__ import annotations


def stage_for_iter(i: int, kernel_start: int, allkernel_start: int, blur_model: str = "dpnerf") -> str:
    if blur_model != "dpnerf" or i < kernel_start:
        return "naive"
    if i < allkernel_start:
        return "kernel"
    return "allkernel"


def consist_active(i: int, noisenerf_start: int) -> bool:
    """Whether the CTE render pass runs this iter (>=, run_lushnerf.py:629)."""
    return i >= noisenerf_start


def consist_in_loss(i: int, noisenerf_start: int) -> bool:
    """Whether the CTE term enters the loss (strict >, run_lushnerf.py:658)."""
    return i > noisenerf_start


def lr_at(step: int, lrate: float, lrate_decay_k: int) -> float:
    """Exponential decay: lrate * 0.1^(step / (lrate_decay*1000))
    (run_lushnerf.py:681-685)."""
    return lrate * (0.1 ** (step / (lrate_decay_k * 1000.0)))
