"""Rigid Blurring Kernel (DP-NeRF RBK): learned per-image SE(3) sub-ray
bundles that reproduce camera motion blur.

Matches models/lushnerf.py:27-175 of the reference, with its module names:
  * `view_embedding_layer.view_embed_layer`: per-image embedding
    [num_img, embed_ch] (torch.nn.Embedding default init N(0, 1)), shared
    with the composed model's `dbk_view_embedding`
  * `view_embed_linears`: trunk MLP (D=4, W=64; with skips=(4,) and D=4 the
    skip never fires)
  * `{r,v,w}_branch` + `{r,v,w}_linear`: rotation screws [N, 3*M] and
    translations [N, 3*M] (both scaled by rv_window), and composite weights
    [N, M+1] (sigmoid, then sum-normalised with +1e-10)
  * r/v output weights ~ U(-1e-5, 1e-5) so warps start near identity;
    their biases keep the torch default (or zero with zero_head_bias)
  * warp: ray origin and origin+dir by each SE(3) motion; warped dir =
    warped_end - warped_origin; slot 0 keeps the original ray.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from lushnerf_torch.models.mlp import make_linear
from lushnerf_torch.ops.se3 import se3_warp


@dataclasses.dataclass(frozen=True)
class RBKConfig:
    num_images: int = 1
    embed_ch: int = 64  # rbk_view_embed_ch
    depth: int = 4  # rbk_enc_brc_depth
    width: int = 64  # rbk_enc_brc_width
    skips: Tuple[int, ...] = (4,)  # rbk_enc_brc_skips
    num_motion: int = 4  # rbk_num_motion
    r_depth: int = 1
    r_width: int = 32
    r_output_ch: int = 3
    v_depth: int = 1
    v_width: int = 32
    v_output_ch: int = 3
    w_depth: int = 1
    w_width: int = 32
    rv_window: float = 0.1  # rbk_se_rv_window
    use_origin: bool = True
    # framework additions (False = reference); see lushnerf_tpu/models/rbk.py
    zero_head_bias: bool = False  # r/v head biases start at 0: exact identity
    guard_dz: bool = False  # warped dz >= -eps (NDC pole) -> original ray
    guard_dz_eps: float = 1e-3
    center_bundle: bool = False  # ccw-weighted mean sub-ray == original ray

    @property
    def num_rays_out(self) -> int:
        return self.num_motion + (1 if self.use_origin else 0)

    def trunk_in_dim(self, i: int) -> int:
        if i == 0:
            return self.embed_ch
        return self.width + self.embed_ch if (i - 1) in self.skips else self.width


class ViewEmbedding(nn.Module):
    """Per-image embedding (reference View_Embedding, :27-35)."""

    def __init__(self, num_images: int, embed_ch: int, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.view_embed_layer = nn.Embedding(num_images, embed_ch, device=device)
        with torch.no_grad():
            self.view_embed_layer.weight.normal_(generator=generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.view_embed_layer(idx)


class RBK(nn.Module):
    """The RBK's parameters under the reference's names; `apply_rbk`
    evaluates them."""

    def __init__(self, cfg: RBKConfig, view_embedding: ViewEmbedding,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        if not cfg.use_origin:
            # the reference crashes on this combination too (rbk_weighted_sum
            # reads a count only set under use_origin); every shipped scene
            # config sets rbk_use_origin
            raise ValueError(
                "rbk_use_origin=False is unsupported: the weight head predicts "
                "num_motion+1 composite weights; set rbk_use_origin=True"
            )
        self.cfg = cfg
        self.view_embedding_layer = view_embedding
        g, dev = generator, device
        self.view_embed_linears = nn.ModuleList(
            [make_linear(cfg.trunk_in_dim(i), cfg.width, g, dev) for i in range(cfg.depth)]
        )
        M = cfg.num_motion

        def branch(depth, width):
            dims = [cfg.width] + [width] * depth
            return nn.ModuleList([make_linear(dims[i], dims[i + 1], g, dev) for i in range(depth)])

        def tiny_head(fan_in, fan_out):
            lin = make_linear(fan_in, fan_out, g, dev, bound_w=1.0e-5)
            if cfg.zero_head_bias:
                with torch.no_grad():
                    lin.bias.zero_()
            return lin

        self.r_branch = branch(cfg.r_depth, cfg.r_width)
        self.r_linear = tiny_head(cfg.r_width, cfg.r_output_ch * M)
        self.v_branch = branch(cfg.v_depth, cfg.v_width)
        self.v_linear = tiny_head(cfg.v_width, cfg.v_output_ch * M)
        self.w_branch = branch(cfg.w_depth, cfg.w_width)
        self.w_linear = make_linear(cfg.w_width, M + 1, g, dev)


def apply_rbk(rbk: RBK, rays: torch.Tensor, image_idx: torch.Tensor):
    """Sub-ray bundles for a batch of rays.

    rays: [N, 3, 2] (origin, direction on the last axis); image_idx: [N] int.
    Returns (sub_rays [N, M+1, 3, 2], ccw [N, M+1]).
    """
    cfg = rbk.cfg
    e = rbk.view_embedding_layer(image_idx.long())  # [N, embed_ch]
    h = e
    for i, lin in enumerate(rbk.view_embed_linears):
        h = torch.relu(lin(h))
        if i in cfg.skips:
            h = torch.cat([e, h], dim=-1)

    h_r, h_v, h_w = h, h, h
    for lin in rbk.r_branch:
        h_r = torch.relu(lin(h_r))
    for lin in rbk.v_branch:
        h_v = torch.relu(lin(h_v))
    for lin in rbk.w_branch:
        h_w = torch.relu(lin(h_w))

    M = cfg.num_motion
    r = rbk.r_linear(h_r) * cfg.rv_window  # [N, 3*M]
    v = rbk.v_linear(h_v) * cfg.rv_window
    w = torch.sigmoid(rbk.w_linear(h_w))  # [N, M+1]
    ccw = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-10)

    # reference reshape [N, 3, M] (models/lushnerf.py:76-77) -> [N, M, 3]
    r = r.reshape(-1, 3, M).transpose(1, 2)
    v = v.reshape(-1, 3, M).transpose(1, 2)

    rays_o = rays[..., 0]  # [N, 3]
    rays_d = rays[..., 1]
    ends = rays_o + rays_d
    warped_o = se3_warp(rays_o[:, None, :].expand(r.shape), r, v)  # [N, M, 3]
    warped_end = se3_warp(ends[:, None, :].expand(r.shape), r, v)
    warped_d = warped_end - warped_o

    warped = torch.stack([warped_o, warped_d], dim=-1)  # [N, M, 3, 2]
    orig = torch.stack([rays_o, rays_d], dim=-1)  # [N, 3, 2]
    sub_rays = torch.cat([orig[:, None], warped], dim=1)  # [N, M+1, 3, 2]
    if cfg.center_bundle:
        # pin the bundle's ccw-weighted mean ray to the original ray
        mean_sub = rbk_weighted_sum(sub_rays, ccw)
        sub_rays = sub_rays - (mean_sub - orig)[:, None]
    if cfg.guard_dz:
        # forward-facing rays have dz < 0; dz >= -eps would blow up the NDC
        # projection -> fall back to the original ray for that slot
        ok = sub_rays[..., 2, 1] < -cfg.guard_dz_eps  # [N, M+1]
        sub_rays = torch.where(ok[..., None, None], sub_rays, orig[:, None])
    return sub_rays, ccw


def rbk_weighted_sum(x: torch.Tensor, ccw: torch.Tensor) -> torch.Tensor:
    """Composite per-sub-ray quantities: x [N, M+1, ...], ccw [N, M+1]."""
    ccw = ccw.reshape(ccw.shape + (1,) * (x.dim() - 2))
    return torch.sum(x * ccw, dim=1)
