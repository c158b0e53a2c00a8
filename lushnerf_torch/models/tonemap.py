"""Tone mapping of rendered linear radiance to LDR color.

Matches ToneMapping (utils/run_lushnerf_helpers.py:134-183) for the
parameter-free maps:
  * 'none'   identity
  * 'gamma'  x^(1/2.2)   (all shipped scene configs use this)
The learned maps ('learn', 'split_linear') are not ported yet.
"""

from __future__ import annotations

import torch

VALID_TYPES = ("none", "gamma")


def apply_tonemap(map_type: str, x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """eps (0.0 = reference) floors the gamma input: (max(x, 0) + eps)^(1/2.2),
    which bounds the x^(1/2.2) gradient pole at x = 0 (torch.maximum, not
    clamp, so the gradient at x = 0 matches the JAX package)."""
    if map_type == "none":
        return x
    if map_type == "gamma":
        if eps > 0.0:
            x = torch.maximum(x, torch.zeros_like(x)) + eps
        return x ** (1.0 / 2.2)
    raise ValueError(f"tone mapping type {map_type!r} not ported (have {VALID_TYPES})")
