"""Inference primitives of the DKMv3 port (NCHW), a port of
lushnerf_tpu/matcher/dkm/nn.py on torch ops.

Every parameter comes from a shape table keyed by the checkpoint's torch
state-dict names (`encoder.net.conv1.weight`, ...): `Conv` and `FrozenBN`
are built from the shapes of `<name>.weight` (and `<name>.bias`), and each
module sits in the tree at the path `name` spells, so a state dict of
those keys loads with `load_state_dict(strict=True)`.  BatchNorm runs in
eval mode on its running stats: the matcher is frozen (DKMv3 freezes BN
even in training, DKMv3.py:449-455).

The JAX package's `patch` forms of grid_sample and local_correlation
(`grid_sample_patch`, `_local_correlation_patch`) are a TPU lowering of
the same values and are not ported: here the gather form is torch's
`F.grid_sample`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

Shapes = Dict[str, torch.Size]


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN convolutions inside, restored after:
    the matcher computes the f32 that its CPU parity holds."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _param(shapes: Shapes, key: str) -> Optional[nn.Parameter]:
    shape = shapes.get(key)
    if shape is None:
        return None
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class Conv(nn.Module):
    """A 2-D convolution with weight [O, I/g, kh, kw] (and bias [O] when
    the table has one).  groups is the input's channel count when
    `depthwise`, else 1.  compute_dtype: the inputs' precision (float32,
    or bfloat16 with the output and the bias in f32)."""

    def __init__(self, shapes: Shapes, name: str, stride: int = 1, padding: int = 0,
                 depthwise: bool = False):
        super().__init__()
        self.weight = _param(shapes, f"{name}.weight")
        self.bias = _param(shapes, f"{name}.bias")
        self.stride, self.padding, self.depthwise = stride, padding, depthwise
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        groups = x.shape[1] if self.depthwise else 1
        if self.compute_dtype == torch.float32:
            return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, 1, groups)
        cd = self.compute_dtype
        y = F.conv2d(x.to(cd), self.weight.to(cd), None, self.stride, self.padding, 1,
                     groups).float()
        return y if self.bias is None else y + self.bias[None, :, None, None]


class FrozenBN(nn.Module):
    """Eval-mode BatchNorm2d: x * g / sqrt(var + eps) + (b - mean * that)."""

    def __init__(self, shapes: Shapes, name: str, eps: float = 1e-5):
        super().__init__()
        self.weight = _param(shapes, f"{name}.weight")
        self.bias = _param(shapes, f"{name}.bias")
        self.register_buffer("running_mean", torch.zeros(shapes[f"{name}.running_mean"]))
        self.register_buffer("running_var", torch.ones(shapes[f"{name}.running_var"]))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * inv[None, :, None, None] + (self.bias - self.running_mean * inv)[None, :, None, None]


def maxpool2d(x, kernel=3, stride=2, padding=1):
    return F.max_pool2d(x, kernel, stride, padding)


def interpolate_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False), no antialias:
    what the JAX package's resize matrices reproduce."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                         align_corners=False)


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """F.grid_sample(align_corners=False, padding_mode='zeros').
    img: [N, C, H, W]; grid: [N, Ho, Wo, 2] with (x, y) in [-1, 1]."""
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


def meshgrid_coords(h: int, w: int, device=None) -> torch.Tensor:
    """The DKM convention: centres at linspace(-1+1/h, 1-1/h, h), stacked
    as (x, y) channels-last [h, w, 2] (DKMv3.py:848-858)."""
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, device=device)
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def local_correlation(feature0: torch.Tensor, feature1: torch.Tensor, local_radius: int,
                      flow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(2r+1)^2 windowed correlation (gim/dkm/utils/local_correlation.py),
    in the gather form: one grid_sample of feature1 over an [h, w*K] grid.

    feature0, feature1: [N, C, H, W]; flow: [N, 2, H, W] or None.
    Returns [N, (2r+1)^2, H, W]."""
    b, c, h, w = feature0.shape
    r = local_radius
    if flow is None:
        coords = meshgrid_coords(h, w, feature0.device)[None].expand(b, h, w, 2)
    else:
        coords = flow.permute(0, 2, 3, 1)
    wy = torch.linspace(-2 * r / h, 2 * r / h, 2 * r + 1, device=feature0.device)
    wx = torch.linspace(-2 * r / w, 2 * r / w, 2 * r + 1, device=feature0.device)
    gy, gx = torch.meshgrid(wy, wx, indexing="ij")
    K = (2 * r + 1) ** 2
    window = torch.stack([gx, gy], dim=-1).reshape(1, K, 2)
    # coords [b, h, w, 1, 2] + window [1, 1, 1, K, 2] -> [b, h, w*K, 2]
    sample = (coords[:, :, :, None] + window[:, None, None]).reshape(b, h, w * K, 2)
    window_feature = grid_sample_bilinear(feature1, sample).reshape(b, c, h, w, K)
    return torch.einsum("bchw,bchwk->bkhw", feature0, window_feature) / (c ** 0.5)
