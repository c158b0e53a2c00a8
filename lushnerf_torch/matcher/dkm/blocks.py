"""DKMv3 building blocks: GP flow regression, the DFN decoder pieces and
the ConvRefiner stack (DKMv3.py:536-895), inference only, as nn.Modules
under the checkpoint's names; a port of lushnerf_tpu/matcher/dkm/blocks.py.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lushnerf_torch.matcher.dkm.nn import (
    Conv,
    FrozenBN,
    Shapes,
    grid_sample_bilinear,
    local_correlation,
    meshgrid_coords,
)

# ---------------------------------------------------------------------------
# GP (DKMv3.py:780-895; configured no_cov=True, fourier basis, T=0.2)
# ---------------------------------------------------------------------------


def cos_kernel(x: torch.Tensor, y: torch.Tensor, T: float = 0.2, eps: float = 1e-6):
    """K = exp((cos_sim - 1) / T) (CosKernel, DKMv3.py:651-669)."""
    c = torch.einsum("bnd,bmd->bnm", x, y) / (
        torch.linalg.norm(x, dim=-1)[..., None] * torch.linalg.norm(y, dim=-1)[:, None] + eps
    )
    return torch.exp((c - 1.0) / T)


class GP(nn.Module):
    """GP posterior mean embedding of match coordinates (no_cov=True):
    K_xy (K_yy + sigma I)^-1 f with f = cos(8 pi pos_conv(coords)), the
    reference's inverse taken as a solve (torch.linalg.inv,
    DKMv3.py:874-885)."""

    def __init__(self, shapes: Shapes, prefix: str, T: float = 0.2, sigma_noise: float = 0.1):
        super().__init__()
        self.pos_conv = Conv(shapes, f"{prefix}.pos_conv")
        self.T, self.sigma_noise = T, sigma_noise

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: [B, C, H, W] projected features -> [B, gp_dim, H, W]."""
        b, c, h1, w1 = x.shape
        _, _, h2, w2 = y.shape
        coords = meshgrid_coords(h2, w2, x.device).permute(2, 0, 1)[None].expand(b, 2, h2, w2)
        f = torch.cos(8.0 * math.pi * self.pos_conv(coords))

        def rs(t):
            return t.permute(0, 2, 3, 1).reshape(b, -1, t.shape[1])

        xf, yf, ff = rs(x), rs(y), rs(f)
        K_yy = cos_kernel(yf, yf, self.T)
        K_xy = cos_kernel(xf, yf, self.T)
        eye = torch.eye(h2 * w2, dtype=x.dtype, device=x.device)[None]
        mu = torch.einsum("bnm,bmd->bnd", K_xy, torch.linalg.solve(K_yy + self.sigma_noise * eye, ff))
        return mu.reshape(b, h1, w1, -1).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# RRB / CAB / DFN (DKMv3.py:672-779)
# ---------------------------------------------------------------------------


class RRB(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str):
        super().__init__()
        self.conv1 = Conv(shapes, f"{prefix}.conv1")
        self.conv2 = Conv(shapes, f"{prefix}.conv2", padding=1)
        self.bn = FrozenBN(shapes, f"{prefix}.bn")
        self.conv3 = Conv(shapes, f"{prefix}.conv3", padding=1)

    def forward(self, x):
        x = self.conv1(x)
        res = torch.relu(self.bn(self.conv2(x)))
        return torch.relu(x + self.conv3(res))


class CAB(nn.Module):
    def __init__(self, shapes: Shapes, prefix: str):
        super().__init__()
        self.conv1 = Conv(shapes, f"{prefix}.conv1")
        self.conv2 = Conv(shapes, f"{prefix}.conv2")

    def forward(self, x1, x2):
        x = torch.mean(torch.cat([x1, x2], dim=1), dim=(2, 3), keepdim=True)
        x = torch.sigmoid(self.conv2(torch.relu(self.conv1(x))))
        return x * x2 + x1


COARSE_KEYS = ("32", "16")


class DFN(nn.Module):
    """The coarse-scale coordinate decoder (DFN.forward, DKMv3.py:769-779),
    one set of modules per coarse scale."""

    def __init__(self, shapes: Shapes, prefix: str):
        super().__init__()
        keys = COARSE_KEYS

        def convs(part):
            return nn.ModuleDict({k: Conv(shapes, f"{prefix}.{part}.{k}") for k in keys})

        self.feat_input_modules = convs("feat_input_modules")
        self.rrb_d = nn.ModuleDict({k: RRB(shapes, f"{prefix}.rrb_d.{k}") for k in keys})
        self.cab = nn.ModuleDict({k: CAB(shapes, f"{prefix}.cab.{k}") for k in keys})
        self.rrb_u = nn.ModuleDict({k: RRB(shapes, f"{prefix}.rrb_u.{k}") for k in keys})
        self.terminal_module = convs("terminal_module")

    def forward(self, embeddings, feats, context, key: str):
        """Returns (pred_coord [B,2,h,w], pred_certainty [B,1,h,w], context)."""
        feats = self.feat_input_modules[key](feats)
        emb = self.rrb_d[key](torch.cat([feats, embeddings], dim=1))
        context = self.rrb_u[key](self.cab[key](context, emb))
        preds = self.terminal_module[key](context)
        return preds[:, -2:], preds[:, :-2], context


# ---------------------------------------------------------------------------
# ConvRefiner (DKMv3.py:536-648; dw=True, 8 hidden blocks, k=5)
# ---------------------------------------------------------------------------

# scale -> local-correlation radius (None: no correlation); all scales use
# the displacement embedding
REFINER_CFG = {"16": 7, "8": 3, "4": 2, "2": None, "1": None}
HIDDEN_BLOCKS = 8


def dw_block(shapes: Shapes, prefix: str) -> nn.Sequential:
    """create_block (:575-598): depthwise conv k5, BN, relu, 1x1 conv (the
    keys .0, .1, .3 of the reference's Sequential)."""
    return nn.Sequential(Conv(shapes, f"{prefix}.0", padding=2, depthwise=True),
                         FrozenBN(shapes, f"{prefix}.1"), nn.ReLU(),
                         Conv(shapes, f"{prefix}.3"))


class ConvRefiner(nn.Module):
    """Refines a flow field (ConvRefiner.forward, DKMv3.py:601-648)."""

    def __init__(self, shapes: Shapes, prefix: str, scale: str,
                 hidden_blocks: int = HIDDEN_BLOCKS):
        super().__init__()
        self.radius = REFINER_CFG[scale]
        self.block1 = dw_block(shapes, f"{prefix}.block1")
        self.hidden_blocks = nn.Sequential(*[dw_block(shapes, f"{prefix}.hidden_blocks.{i}")
                                             for i in range(hidden_blocks)])
        self.out_conv = Conv(shapes, f"{prefix}.out_conv")
        self.disp_emb = Conv(shapes, f"{prefix}.disp_emb")

    def forward(self, x, y, flow):
        """x, y: [B, C, hs, ws] feature maps; flow: [B, 2, hs, ws] in [-1, 1].
        Returns (certainty [B,1,hs,ws], displacement [B,2,hs,ws])."""
        b, c, hs, ws = x.shape
        x_hat = grid_sample_bilinear(y, flow.permute(0, 2, 3, 1))
        query_coords = meshgrid_coords(hs, ws, x.device).permute(2, 0, 1)[None]
        emb = self.disp_emb(flow - query_coords)
        parts = [x, x_hat, emb]
        if self.radius is not None:
            # corr_in_other=True: correlate around the predicted coordinate
            # in the other image (DKMv3.py:630-633)
            parts.append(local_correlation(x, y, self.radius, flow=flow))
        d = self.hidden_blocks(self.block1(torch.cat(parts, dim=1)))
        d = self.out_conv(d)
        return d[:, :-2], d[:, -2:]
