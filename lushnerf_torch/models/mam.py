"""Motion Aggregation Module (MAM).

A port of lushnerf_tpu/models/mam.py, the counterpart of the reference's
models/mam.py (Correlation_Module :13-54, Motion_Aggregation_Module
:57-85).  The reference imports MAM but never builds it
(models/lushnerf.py:6); it is here for parity of the framework's surface
and for experiments.

Attention between a per-ray global feature [B, N, C] and per-motion sample
features [B*(M+1), L, 64]: line-attention pooling over the motion ("curve")
grid, two cross-attention reads, 1x1-conv mixing with a BatchNorm in
training mode (the batch's statistics, biased variance), leaky relu 0.2.
The 1x1 convolutions are held as [in, out] matrices, as the JAX package's.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lushnerf_torch.models.lushnerf import resolve_device
from lushnerf_torch.models.mlp import make_linear

CONVS = {  # name -> (in, out) as multiples of (in_channels, mid = in_channels // 2)
    "conva": ("c", "m"), "convb": ("c", "m"), "convc": ("c", "m"), "convn": ("m", "m"),
    "convl": ("m", "m"), "convd": ("2m", "c"), "line_att": ("c", "1"),
}
LOCAL_CH = 64  # the per-sample features' channels
BN_EPS = 1e-5
LEAKY_SLOPE = 0.2


class MotionAggregation(nn.Module):
    """The parameters of `init_mam`: the 1x1 convs (bias-free, [in, out],
    torch Conv1d's default init U(-1/sqrt(in), 1/sqrt(in))), the BatchNorm's
    affine `convd_bn_weight` / `convd_bn_bias`, and `linear` (64 -> 32)."""

    def __init__(self, in_channels: int, num_motion: int, generator: torch.Generator,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_motion = num_motion
        dims = {"c": in_channels, "m": in_channels // 2, "2m": 2 * (in_channels // 2), "1": 1}
        for name, (i, o) in CONVS.items():
            bound = 1.0 / math.sqrt(dims[i])
            w = torch.empty(dims[i], dims[o]).uniform_(-bound, bound, generator=generator)
            setattr(self, name, nn.Parameter(w.to(device)))
        self.convd_bn_weight = nn.Parameter(torch.ones(in_channels, device=device))
        self.convd_bn_bias = nn.Parameter(torch.zeros(in_channels, device=device))
        self.linear = make_linear(LOCAL_CH, LOCAL_CH // 2, generator, device)

    def forward(self, x_global: torch.Tensor, x_local: torch.Tensor) -> torch.Tensor:
        return apply_mam(self, x_global, x_local)


def _batchnorm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, dims,
                     eps: float = BN_EPS) -> torch.Tensor:
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    shape = [1] * x.ndim
    shape[1] = -1
    return (x - mean) / torch.sqrt(var + eps) * gamma.reshape(shape) + beta.reshape(shape)


def correlation_module(p: MotionAggregation, x: torch.Tensor,
                       curves: torch.Tensor) -> torch.Tensor:
    """x: [B, C, N]; curves: [B, C, c_n, c_l] -> [B, C, N]."""
    # line attention over the curve grid (1x1 conv2d == channel matmul)
    att = torch.einsum("bcnl,co->bonl", curves, p.line_att)  # [B, 1, c_n, c_l]
    inter = torch.sum(curves * torch.softmax(att, dim=-1), dim=-1)  # [B, C, c_n]
    intra = torch.sum(curves * torch.softmax(att, dim=-2), dim=-2)  # [B, C, c_l]

    inter = torch.einsum("bcn,cm->bmn", inter, p.conva)  # [B, mid, c_n]
    intra = torch.einsum("bcl,cm->bml", intra, p.convb)  # [B, mid, c_l]

    x_logits = torch.einsum("bcn,cm->bnm", x, p.convc)  # [B, N, mid]
    x_inter = torch.softmax(torch.einsum("bnm,bmk->bnk", x_logits, inter), dim=-1)
    x_intra = torch.softmax(torch.einsum("bnm,bml->bnl", x_logits, intra), dim=-1)

    inter_v = torch.einsum("bmk,mo->bko", inter, p.convn)  # [B, c_n, mid]
    intra_v = torch.einsum("bml,mo->blo", intra, p.convl)  # [B, c_l, mid]

    x_i = torch.einsum("bnk,bko->bno", x_inter, inter_v)
    x_a = torch.einsum("bnl,blo->bno", x_intra, intra_v)

    feats = torch.cat([x_i, x_a], dim=-1)  # [B, N, 2*mid]
    mixed = torch.einsum("bnc,co->bon", feats, p.convd)  # [B, C, N]
    mixed = _batchnorm_train(mixed, p.convd_bn_weight, p.convd_bn_bias, dims=(0, 2))
    return F.leaky_relu(x + mixed, negative_slope=LEAKY_SLOPE)


def apply_mam(p: MotionAggregation, x_global: torch.Tensor,
              x_local: torch.Tensor) -> torch.Tensor:
    """x_global: [N_ray, N_motion_groups, C]; x_local: [N_ray * (M+1), L, 64].

    Returns the aggregated features [N_ray, N, C] (reference forward :68-84).
    """
    M1 = p.num_motion + 1
    n_ray = x_local.shape[0] // M1
    xl = x_local.reshape(n_ray, M1, x_local.shape[1], x_local.shape[2])
    xl = p.linear(xl)  # [N_ray, M+1, L, 32]
    xl = xl.permute(0, 3, 1, 2)  # [B, C, N(motion), L(sample)]
    xg = x_global.permute(0, 2, 1)  # [B, C, N]
    out = correlation_module(p, xg, xl)
    return out.permute(0, 2, 1)


def mam_from_jax(params: Dict[str, Any], device: str | torch.device = "cuda"
                 ) -> MotionAggregation:
    """A JAX `init_mam` params tree (numpy leaves) -> `MotionAggregation`
    on `device`."""
    in_channels = np.asarray(params["conva"]).shape[0]
    mam = MotionAggregation(in_channels, int(params["num_motion"]),
                            torch.Generator().manual_seed(0), "cpu")

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    gamma, beta = params["convd_bn"]
    w, b = params["linear"]
    state = {name: t(params[name]) for name in CONVS}
    state.update(convd_bn_weight=t(gamma), convd_bn_bias=t(beta),
                 **{"linear.weight": t(w).T.contiguous(), "linear.bias": t(b)})
    mam.load_state_dict(state, strict=True)
    return mam.to(device)
