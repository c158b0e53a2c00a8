"""DKMv3's symmetric match of one image pair in plain PyTorch, float32 with
TF32 off: the yardstick the program's match tables are held to.

A frozen, independent transcription of the published matcher (Edstedt et
al., "DKM: Dense Kernelized Feature Matching for Geometry Estimation",
CVPR 2023, arXiv 2202.00667) as GIM ships it (github.com/xuelunshen/gim,
`gim/dkm/models/model_zoo/DKMv3.py`: the factory at :1310-1449,
`RegressionMatcher.match` at :1218-1308; `gim/dkm/utils/
local_correlation.py`), at the widths the weights give.  It imports
nothing of the program: the weights come as a dict of tensors under the
checkpoint's state-dict names (`encoder.net.conv1.weight`, ...,
`decoder.conv_refiner.1.out_conv.bias`), with BatchNorm's running
statistics.

The path, for one pair (query, support) at (hs, ws):
  * the ResNet-50 pyramid (torchvision's Bottleneck v1.5, stride on the
    3x3 conv) at strides 1-32, BatchNorm frozen (eval statistics), one
    encoder pass over [query; support];
  * the decoder on the batch [query; support] against [support; query]:
    proj 1x1 convs at 32 and 16; the GP at 32 and 16 (cosine kernel,
    T 0.2, exp((cos - 1) / T); a Fourier basis cos(8 pi pos_conv(grid)) of
    the support grid; the posterior mean K_xy (K_yy + 0.1 I)^-1 f, with
    the inverse taken as GIM takes it, torch.linalg.inv); the DFN (RRB,
    CAB, RRB, terminal conv) at 32 and 16; the ConvRefiners at 16, 8, 4, 2
    and 1 (the support warped by grid_sample to the flow, the displacement
    embedding, the local correlation in the support around the flow at
    radius 7 / 3 / 2, a depthwise 5x5 block and 8 hidden ones, the out
    conv), each adding scale x its displacement / (4 w, 4 h) to the flow
    and its certainty logit; bilinear upsampling between scales;
  * the second, upsampled pass (scales 8 to 1) from the first pass's
    finest flow and certainty, with the encoder run again;
  * the low-res certainty correction (0.5 x the stride-16 logit where it
    is negative, upsampled to (hs, ws), subtracted), the sigmoid, the
    `wrong` mask (certainty 0 where the flow leaves [-1, 1]) and the clamp.

Departures from GIM's code, none of which changes a value beyond rounding:
  * the images are [3, H, W] tensors in [0, 1], resized to (hs, ws) with
    bilinear interpolation (align_corners False) and not normalised, as
    LuSh-NeRF feeds its renders to `match`; the first pass runs at (hs,
    ws) too (LuSh's 640 x 1120 for both);
  * the local correlation divides the product by sqrt(c) after the sum
    over channels (GIM divides feature0 before it);
  * the GP's covariance (no_cov) and the training-only paths are left out.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
BLOCKS = ((1, 3), (2, 4), (3, 6), (4, 3))  # ResNet-50: (layer, bottlenecks)
COARSE = (32, 16)  # GP + DFN
REFINERS = {16: 7, 8: 3, 4: 2, 2: None, 1: None}  # scale: local-correlation radius
HIDDEN_BLOCKS = 8
GP_T, GP_SIGMA = 0.2, 0.1
REFINE_INIT = 4.0
LOW_RES_FACTOR = 0.5


def conv(p: Params, name: str, x, stride: int = 1, padding: int = 0, groups: int = 1):
    return F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), stride, padding, 1, groups)


def frozen_bn(p: Params, name: str, x, eps: float = 1e-5):
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, eps)


def grid(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """Pixel centres in [-1, 1], [h, w, 2] as (x, y)."""
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, dtype=like.dtype, device=like.device)
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, dtype=like.dtype, device=like.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def upsample(x, size):
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                         align_corners=False)


def sample(img, coords):
    """Bilinear samples of img [B, C, H, W] at coords [B, h, w, 2], zeros
    outside."""
    return F.grid_sample(img, coords, mode="bilinear", padding_mode="zeros", align_corners=False)


# -- the encoder --------------------------------------------------------------

def bottleneck(p: Params, name: str, x, stride: int):
    out = torch.relu(frozen_bn(p, f"{name}.bn1", conv(p, f"{name}.conv1", x)))
    out = torch.relu(frozen_bn(p, f"{name}.bn2", conv(p, f"{name}.conv2", out, stride, 1)))
    out = frozen_bn(p, f"{name}.bn3", conv(p, f"{name}.conv3", out))
    if f"{name}.downsample.0.weight" in p:
        x = frozen_bn(p, f"{name}.downsample.1", conv(p, f"{name}.downsample.0", x, stride))
    return torch.relu(out + x)


def resnet50(p: Params, x) -> Dict[int, torch.Tensor]:
    """{stride: features} at strides 1 (the image), 2, 4, 8, 16, 32."""
    pre = "encoder.net"
    feats = {1: x}
    x = torch.relu(frozen_bn(p, f"{pre}.bn1", conv(p, f"{pre}.conv1", x, 2, 3)))
    feats[2] = x
    x = F.max_pool2d(x, 3, 2, 1)
    for layer, n in BLOCKS:
        for b in range(n):
            x = bottleneck(p, f"{pre}.layer{layer}.{b}", x, 2 if b == 0 and layer > 1 else 1)
        feats[2 ** (layer + 1)] = x
    return feats


# -- the GP and the DFN ---------------------------------------------------------

def cos_kernel(x, y, eps: float = 1e-6):
    """exp((cos(x_n, y_m) - 1) / T) for x [B, n, d], y [B, m, d]."""
    c = torch.einsum("bnd,bmd->bnm", x, y) / (
        x.norm(dim=-1)[..., None] * y.norm(dim=-1)[:, None] + eps)
    return torch.exp((c - 1.0) / GP_T)


def gp(p: Params, scale: int, x, y):
    """The GP's posterior mean embedding [B, gp_dim, h, w] of x's positions
    in y, from the projected features x, y [B, c, h, w]."""
    b, _, h1, w1 = x.shape
    _, _, h2, w2 = y.shape
    coords = grid(h2, w2, y).permute(2, 0, 1)[None].expand(b, 2, h2, w2)
    f = torch.cos(8 * math.pi * conv(p, f"decoder.gps.{scale}.pos_conv", coords))

    def rows(t):  # [B, C, h, w] -> [B, h w, C]
        return t.flatten(2).transpose(1, 2)

    x, y, f = rows(x), rows(y), rows(f)
    k_yy = cos_kernel(y, y)
    k_xy = cos_kernel(x, y)
    noise = GP_SIGMA * torch.eye(h2 * w2, dtype=y.dtype, device=y.device)[None]
    k_yy_inv = torch.linalg.inv(k_yy + noise)
    mu = k_xy @ (k_yy_inv @ f)
    return mu.transpose(1, 2).reshape(b, -1, h1, w1)


def rrb(p: Params, name: str, x):
    x = conv(p, f"{name}.conv1", x)
    res = torch.relu(frozen_bn(p, f"{name}.bn", conv(p, f"{name}.conv2", x, padding=1)))
    return torch.relu(x + conv(p, f"{name}.conv3", res, padding=1))


def cab(p: Params, name: str, high, low):
    w = torch.mean(torch.cat([high, low], dim=1), dim=(2, 3), keepdim=True)
    w = torch.sigmoid(conv(p, f"{name}.conv2", torch.relu(conv(p, f"{name}.conv1", w))))
    return w * low + high


def dfn(p: Params, scale: int, embedding, feats, context):
    """(flow [B, 2, h, w], certainty logit [B, 1, h, w], context)."""
    pre = "decoder.embedding_decoder"
    feats = conv(p, f"{pre}.feat_input_modules.{scale}", feats)
    emb = rrb(p, f"{pre}.rrb_d.{scale}", torch.cat([feats, embedding], dim=1))
    context = rrb(p, f"{pre}.rrb_u.{scale}", cab(p, f"{pre}.cab.{scale}", context, emb))
    preds = conv(p, f"{pre}.terminal_module.{scale}", context)
    return preds[:, -2:], preds[:, :-2], context


# -- the refiners ---------------------------------------------------------------

def local_correlation(f0, f1, radius: int, flow):
    """[B, (2r+1)^2, h, w]: f0 against f1 sampled in a (2r+1)^2 window
    around the flow's coordinate, one image at a time."""
    b, c, h, w = f0.shape
    k = (2 * radius + 1) ** 2
    wy = torch.linspace(-2 * radius / h, 2 * radius / h, 2 * radius + 1, dtype=f0.dtype,
                        device=f0.device)
    wx = torch.linspace(-2 * radius / w, 2 * radius / w, 2 * radius + 1, dtype=f0.dtype,
                        device=f0.device)
    gy, gx = torch.meshgrid(wy, wx, indexing="ij")
    window = torch.stack([gx, gy], dim=-1).reshape(1, 1, 1, k, 2)
    coords = flow.permute(0, 2, 3, 1)
    out = []
    for i in range(b):
        at = (coords[i:i + 1, :, :, None] + window).reshape(1, h, w * k, 2)
        win = sample(f1[i:i + 1], at).reshape(c, h, w, k)
        out.append((f0[i, ..., None] * win).sum(dim=0).permute(2, 0, 1) / math.sqrt(c))
    return torch.stack(out)


def dw_block(p: Params, name: str, x):
    x = conv(p, f"{name}.0", x, padding=2, groups=x.shape[1])
    return conv(p, f"{name}.3", torch.relu(frozen_bn(p, f"{name}.1", x)))


def refiner(p: Params, scale: int, x, y, flow):
    """(certainty logit change [B, 1, h, w], displacement [B, 2, h, w])."""
    pre = f"decoder.conv_refiner.{scale}"
    b, _, h, w = x.shape
    x_hat = sample(y, flow.permute(0, 2, 3, 1))
    query = grid(h, w, x).permute(2, 0, 1)[None]
    parts = [x, x_hat, conv(p, f"{pre}.disp_emb", flow - query)]
    if REFINERS[scale] is not None:
        parts.append(local_correlation(x, y, REFINERS[scale], flow))
    d = dw_block(p, f"{pre}.block1", torch.cat(parts, dim=1))
    for i in range(HIDDEN_BLOCKS):
        d = dw_block(p, f"{pre}.hidden_blocks.{i}", d)
    d = conv(p, f"{pre}.out_conv", d)
    return d[:, :-2], d[:, -2:]


# -- the decoder and the match ----------------------------------------------------

def decoder(p: Params, f1, f2, first: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """{scale: (flow [B, 2, h, w], certainty logit [B, 1, h, w])}: the
    first pass (first None) from 32 to 1, or the upsampled pass from 8 to
    1 seeded by the first pass's finest (flow, certainty)."""
    scales = [32, 16, 8, 4, 2, 1] if first is None else [8, 4, 2, 1]
    sizes = {s: f.shape[-2:] for s, f in f1.items()}
    h, w = sizes[1]
    b = f1[1].shape[0]
    top = scales[0]
    context = torch.zeros((b, 384, *sizes[top]), dtype=f1[top].dtype, device=f1[top].device)
    if first is None:
        flow = grid(*sizes[top], f1[top]).permute(2, 0, 1)[None].expand(b, 2, *sizes[top])
        cert = torch.zeros((b, 1, *sizes[top]), dtype=f1[top].dtype, device=f1[top].device)
    else:
        flow, cert = upsample(first[0], sizes[top]), upsample(first[1], sizes[top])
    out = {}
    for s in scales:
        x, y = f1[s], f2[s]
        if s in COARSE:
            x, y = conv(p, f"decoder.proj.{s}", x), conv(p, f"decoder.proj.{s}", y)
            context = upsample(context, sizes[s])
            flow, cert, context = dfn(p, s, gp(p, s, x, y), x, context)
        if s in REFINERS:
            dcert, disp = refiner(p, s, x, y, flow)
            flow = flow + s * torch.stack([disp[:, 0] / (REFINE_INIT * w),
                                           disp[:, 1] / (REFINE_INIT * h)], dim=1)
            cert = cert + dcert
        out[s] = (flow, cert)
        if s != 1:
            flow, cert = upsample(flow, sizes[s // 2]), upsample(cert, sizes[s // 2])
    return out


def symmetric_pass(p: Params, query, support, first=None):
    """The encoder over [query; support] and the decoder against the
    swapped batch."""
    feats = resnet50(p, torch.cat([query, support]))
    swapped = {s: torch.cat([f[1:], f[:1]]) for s, f in feats.items()}
    return decoder(p, feats, swapped, first)


def match(p: Params, im0: torch.Tensor, im1: torch.Tensor, hs: int, ws: int):
    """RegressionMatcher.match, symmetric, with the upsampled pass, for one
    pair of [3, H, W] images in [0, 1].  Returns (warp [hs, 2 ws, 4]:
    (x0, y0, x1, y1) in [-1, 1], the query's half first; certainty [hs,
    2 ws]).  Runs in float32 with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            query = upsample(im0[None].float(), (hs, ws))
            support = upsample(im1[None].float(), (hs, ws))
            first = symmetric_pass(p, query, support)
            low = upsample(first[16][1], (hs, ws))
            low = LOW_RES_FACTOR * low * (low < 0)
            flow, cert = symmetric_pass(p, query, support, first[1])[1]
            flow = flow.permute(0, 2, 3, 1)  # [2, hs, ws, 2]
            cert = torch.sigmoid(cert - low)[:, 0]
            wrong = (flow.abs() > 1).any(dim=-1)
            cert = torch.where(wrong, torch.zeros_like(cert), cert)
            flow = flow.clamp(-1, 1)
            coords = grid(hs, ws, flow)
            q_warp = torch.cat([coords, flow[0]], dim=-1)
            s_warp = torch.cat([flow[1], coords], dim=-1)
            return torch.cat([q_warp, s_warp], dim=1), torch.cat([cert[0], cert[1]], dim=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
