"""Tone mapping of rendered linear radiance to LDR color.

Matches ToneMapping (utils/run_lushnerf_helpers.py:134-183):
  * 'none'          identity
  * 'gamma'         x^(1/2.2)   (all shipped scene configs use this)
  * 'learn'         sigmoid(0.1 * MLP(x) + x) with a 1-16-16-16-1 relu MLP
                    applied to each value
  * 'split_linear'  a 1-64-64-1 relu MLP per channel (r, g, b)

The learned maps' parameters live in a `ToneMapping` module that
`LushNeRF` owns as `tonemapping` (the reference's name), so Adam, the
checkpoints and the data-parallel all-reduce carry them with the rest.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lushnerf_torch.models.mlp import make_linear

VALID_TYPES = ("none", "gamma", "learn", "split_linear")
LEARNED_TYPES = ("learn", "split_linear")
LEARN_DIMS = (1, 16, 16, 16, 1)
SPLIT_DIMS = (1, 64, 64, 1)
LEARN_RESIDUAL_SCALE = 0.1


def _relu_mlp(dims, generator: torch.Generator, device: torch.device) -> nn.Sequential:
    """Linear, ReLU, ..., Linear: the Linears sit at 0, 2, 4, ... as in the
    reference's nn.Sequential, with torch.nn.Linear's init from `generator`."""
    layers = []
    for i in range(len(dims) - 1):
        if i:
            layers.append(nn.ReLU())
        layers.append(make_linear(dims[i], dims[i + 1], generator, device))
    return nn.Sequential(*layers)


class ToneMapping(nn.Module):
    """The learned map of `map_type`: 'learn' holds `linear` (1-16-16-16-1),
    'split_linear' holds `linear_r`, `linear_g`, `linear_b` (1-64-64-1
    each)."""

    def __init__(self, map_type: str, generator: torch.Generator, device: torch.device):
        super().__init__()
        if map_type not in LEARNED_TYPES:
            raise ValueError(f"tone mapping type {map_type!r} has no parameters "
                             f"(learned: {LEARNED_TYPES})")
        self.map_type = map_type
        if map_type == "learn":
            self.linear = _relu_mlp(LEARN_DIMS, generator, device)
        else:
            for ch in "rgb":
                setattr(self, f"linear_{ch}", _relu_mlp(SPLIT_DIMS, generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.map_type == "learn":
            x_in = x.reshape(-1, 1)
            res = self.linear(x_in) * LEARN_RESIDUAL_SCALE
            return torch.sigmoid(res + x_in).reshape(x.shape)
        chans = x.split(1, dim=-1)
        return torch.cat([getattr(self, f"linear_{ch}")(e) for ch, e in zip("rgb", chans)], dim=-1)


def apply_tonemap(map_type: str, x: torch.Tensor, eps: float = 0.0,
                  tonemap: Optional[ToneMapping] = None) -> torch.Tensor:
    """The map `map_type` on x [..., 3]; the learned maps run `tonemap`
    (the model's `tonemapping`).  eps (0.0 = reference) floors the gamma
    input: (max(x, 0) + eps)^(1/2.2), which bounds the x^(1/2.2) gradient
    pole at x = 0 (torch.maximum, not clamp, so the gradient at x = 0
    matches the JAX package)."""
    if map_type == "none":
        return x
    if map_type == "gamma":
        if eps > 0.0:
            x = torch.maximum(x, torch.zeros_like(x)) + eps
        return x ** (1.0 / 2.2)
    if map_type in LEARNED_TYPES:
        if tonemap is None or tonemap.map_type != map_type:
            raise ValueError(f"tone mapping type {map_type!r} needs its ToneMapping module")
        return tonemap(x)
    raise ValueError(f"tone mapping type {map_type!r} not recognized (have {VALID_TYPES})")
