"""DKMv3's model work, from its widths and the match resolution: the
yardstick of `dkm_mfu`.

Counted from the published architecture (perfbench/reference/dkm.py), so
that the share reads the same work whatever implements it:
  * every convolution: 2 x (output pixels) x (output channels) x (input
    channels / groups) x kh x kw FLOP (biases, BatchNorm, activations,
    pooling and resizes are left out);
  * the GP at each coarse scale: its Fourier basis (a 1x1 conv from 2
    channels), the cosine kernels K_yy and K_xy (2 n^2 c each), the solve
    of (K_yy + sigma I) against the basis as an LU factorisation and two
    triangular solves (2/3 n^3 + 2 n^2 d) and the posterior mean K_xy x
    that (2 n^2 d);
  * each local correlation: 2 x pixels x (2r + 1)^2 x channels;
  * gathers (grid_sample, the correlation's window) move bytes and do no
    arithmetic that is counted.
An encoder pass is one view at (hs, ws); a decoder pass is one ordered
pair (the query direction), its first pass at scales 32 to 1 and its
upsampled pass at 8 to 1.  The peak is NVIDIA's H100 SXM data sheet's
67 TFLOP/s of float32 on the CUDA cores: the matcher runs float32 with
TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

PEAK_F32_FLOPS = 67e12
BLOCKS = ((1, 3), (2, 4), (3, 6), (4, 3))
DFN_DIM = 384
HIDDEN_BLOCKS = 8
RADII = {16: 7, 8: 3, 4: 2, 2: None, 1: None}
REFINER_SCALES = (16, 8, 4, 2, 1)
GP_SCALES = (32, 16)


def conv_flop(h: int, w: int, c_out: int, c_in: int, k: int = 1, groups: int = 1) -> float:
    """FLOP of a convolution with an h x w output."""
    return 2.0 * h * w * c_out * (c_in // groups) * k * k


def size_at(hs: int, ws: int, stride: int):
    """The pyramid's size at a stride: each stride-2 step is a 3x3 (or 7x7 /
    pool) with padding, ceil(n / 2)."""
    h, w = hs, ws
    s = 1
    while s < stride:
        h, w, s = -(-h // 2), -(-w // 2), s * 2
    return h, w


def encoder_flop(width: int, hs: int, ws: int) -> float:
    """One ResNet-50 pass over a view at (hs, ws) with base width `width`."""
    h, w = size_at(hs, ws, 2)
    total = conv_flop(h, w, width, 3, 7)
    c_in = width
    for layer, n in BLOCKS:
        planes = width * 2 ** (layer - 1)
        h, w = size_at(hs, ws, 2 ** (layer + 1))
        for b in range(n):
            # conv1 runs at the block's input size (a stride up in a layer's
            # first block past layer 1); conv2 strides
            h_in, w_in = size_at(hs, ws, 2 ** layer) if b == 0 and layer > 1 else (h, w)
            total += conv_flop(h_in, w_in, planes, c_in)
            total += conv_flop(h, w, planes, planes, 3)
            total += conv_flop(h, w, 4 * planes, planes)
            if b == 0:
                total += conv_flop(h, w, 4 * planes, c_in)
            c_in = 4 * planes
    return total


def feature_channels(width: int, proj_dim: int) -> Dict[int, int]:
    return {1: 3, 2: width, 4: 4 * width, 8: 8 * width, 16: proj_dim, 32: proj_dim}


def gp_flop(n: int, c: int, d: int) -> float:
    """The GP over n positions of c-channel features, d basis channels."""
    basis = 2.0 * n * d * 2
    kernels = 2 * (2.0 * n * n * c)
    solve = 2.0 / 3.0 * n ** 3 + 2.0 * n * n * d
    return basis + kernels + solve + 2.0 * n * n * d


def refiner_flop(h: int, w: int, c_feat: int, emb: int, mult: int, radius) -> float:
    k2 = (2 * radius + 1) ** 2 if radius is not None else 0
    c_in = 2 * c_feat + emb + k2
    hid = c_in * mult
    total = conv_flop(h, w, emb, 2)  # the displacement embedding
    if radius is not None:
        total += 2.0 * h * w * k2 * c_feat
    total += conv_flop(h, w, hid, c_in, 5, groups=c_in) + conv_flop(h, w, hid, hid)
    total += HIDDEN_BLOCKS * (conv_flop(h, w, hid, hid, 5, groups=hid) + conv_flop(h, w, hid, hid))
    return total + conv_flop(h, w, 3, hid)


def decoder_flop(width: int, gp_dim: int, feat_dim: int, proj_dim: int,
                 disp_emb: Sequence[int], hidden_mult: Sequence[int], hs: int, ws: int) -> float:
    """Both decoder passes of one ordered pair."""
    ch = feature_channels(width, proj_dim)
    refine = {}
    for s, emb, mult in zip(REFINER_SCALES, disp_emb, hidden_mult):
        h, w = size_at(hs, ws, s)
        refine[s] = refiner_flop(h, w, ch[s], emb, mult, RADII[s])
    total = 0.0
    for s in GP_SCALES:
        h, w = size_at(hs, ws, s)
        n = h * w
        total += 2 * conv_flop(h, w, proj_dim, 32 * width if s == 32 else 16 * width)
        total += gp_flop(n, proj_dim, gp_dim)
        total += conv_flop(h, w, feat_dim, proj_dim)  # feat_input_modules
        for c_in in (gp_dim + feat_dim, DFN_DIM):  # rrb_d, rrb_u
            total += conv_flop(h, w, DFN_DIM, c_in) + 2 * conv_flop(h, w, DFN_DIM, DFN_DIM, 3)
        total += 2.0 * DFN_DIM * 2 * DFN_DIM + 2.0 * DFN_DIM * DFN_DIM  # the CAB's 1x1 convs
        total += conv_flop(h, w, 3, DFN_DIM)  # terminal
    total += sum(refine.values())  # the first pass: 16 to 1
    total += sum(refine[s] for s in (8, 4, 2, 1))  # the upsampled pass
    return total


def rematch_flop(m: dict, views: int, pairs: int) -> float:
    """A rematch's work: an encoder pass a view and both decoder passes an
    ordered pair, for a configuration's `matcher` block."""
    return (views * encoder_flop(m["resnet_width"], m["hs"], m["ws"])
            + pairs * decoder_flop(m["resnet_width"], m["gp_dim"], m["feat_dim"], m["proj_dim"],
                                   m["disp_emb"], m["hidden_mult"], m["hs"], m["ws"]))


def mfu(flop: float, seconds: float) -> float:
    """Per cent of the float32 peak."""
    return 100.0 * flop / seconds / PEAK_F32_FLOPS if seconds > 0 else math.nan
