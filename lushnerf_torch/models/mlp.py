"""NeRF-style MLPs as `nn.Module`s named after the reference's state-dict keys.

Covers both the scene MLPs (coarse/fine, D=8 W=256, skip concat after layer
4, viewdir branch W/2 -> rgb, alpha head; utils/run_lushnerf_helpers.py:
365-452) and the SND noise MLP (D=4 W=128, rgb-only output; :456-512).
Reference quirk kept: with D=4 and skips=(4,) the skip never fires (the
loop index never reaches 4); the construction rule below honours it.

Initialisation is torch.nn.Linear's distribution, W, b ~ U(-k, k) with
k = 1/sqrt(fan_in), drawn from an explicit generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Static architecture of a NeRF-style MLP.

    rgb_only=True gives the SND noise-MLP head (3 channels, no alpha);
    otherwise the output is [rgb, alpha] (4 channels).
    """

    depth: int = 8
    width: int = 256
    input_ch: int = 63
    input_ch_views: int = 27
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    output_ch: int = 4  # only used when use_viewdirs=False
    rgb_only: bool = False

    def layer_in_dim(self, i: int) -> int:
        """Input dim of pts layer i: layer i+1 widens when i is a skip."""
        if i == 0:
            return self.input_ch
        return self.width + self.input_ch if (i - 1) in self.skips else self.width


def make_linear(fan_in: int, fan_out: int, generator: torch.Generator,
                device: torch.device, bound_w: Optional[float] = None) -> nn.Linear:
    """nn.Linear with weight ~ U(-bound_w, bound_w) (default 1/sqrt(fan_in))
    and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from `generator`."""
    lin = nn.Linear(fan_in, fan_out, device=device)
    k = 1.0 / math.sqrt(fan_in)
    bw = k if bound_w is None else bound_w
    with torch.no_grad():
        lin.weight.uniform_(-bw, bw, generator=generator)
        lin.bias.uniform_(-k, k, generator=generator)
    return lin


class NeRFMLP(nn.Module):
    """Submodules: pts_linears, feature_linear, alpha_linear, views_linears,
    rgb_linear (or output_linear without viewdirs), as in the reference."""

    def __init__(self, cfg: MLPConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        W = cfg.width
        self.pts_linears = nn.ModuleList(
            [make_linear(cfg.layer_in_dim(i), W, generator, device) for i in range(cfg.depth)]
        )
        if cfg.use_viewdirs:
            self.feature_linear = make_linear(W, W, generator, device)
            self.alpha_linear = make_linear(W, 1, generator, device)
            self.views_linears = nn.ModuleList(
                [make_linear(cfg.input_ch_views + W, W // 2, generator, device)]
            )
            self.rgb_linear = make_linear(W // 2, 3, generator, device)
        else:
            self.output_linear = make_linear(W, cfg.output_ch, generator, device)

    def forward(self, x_pe: torch.Tensor, d_pe: Optional[torch.Tensor]) -> torch.Tensor:
        """x_pe [..., input_ch], d_pe [..., input_ch_views] -> [..., 4]
        ([rgb_raw, alpha_raw]) or [..., 3] for rgb_only."""
        cfg = self.cfg
        h = x_pe
        for i, lin in enumerate(self.pts_linears):
            h = torch.relu(lin(h))
            if i in cfg.skips:
                h = torch.cat([x_pe, h], dim=-1)
        if not cfg.use_viewdirs:
            return self.output_linear(h)
        alpha = self.alpha_linear(h)
        feature = self.feature_linear(h)
        h = torch.relu(self.views_linears[0](torch.cat([feature, d_pe], dim=-1)))
        rgb = self.rgb_linear(h)
        if cfg.rgb_only:
            return rgb
        return torch.cat([rgb, alpha], dim=-1)
