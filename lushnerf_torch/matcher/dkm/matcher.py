"""DKMv3: the coarse-to-fine decoder, the symmetric match, and the Matcher
adapter the trainer's rematch calls; a port of
lushnerf_tpu/matcher/dkm/matcher.py.

Decoder.forward (DKMv3.py:979-1059) with the shipped config: scales
32..1, GP + DFN at {32, 16}, ConvRefiners at {16, 8, 4, 2, 1}, proj at
{32, 16}, detach=True; RegressionMatcher.match (:1218-1308), symmetric,
with the (640, 1120) two-pass scheme LuSh uses (run_lushnerf.py:349).

The module tree is built from a table of parameter shapes
(`DKM(state_shapes(dims))` for random weights, `DKM.from_state_dict` for
a checkpoint), so every width the code does not fix comes from the
weights.  The code fixes ResNet50's block counts and strides, DFN_DIM,
the refiners' correlation radii and their 8 hidden blocks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from lushnerf_torch.matcher.dkm.blocks import (
    COARSE_KEYS,
    DFN,
    GP,
    HIDDEN_BLOCKS,
    REFINER_CFG,
    ConvRefiner,
)
from lushnerf_torch.matcher.dkm.nn import (
    Conv,
    full_f32,
    interpolate_bilinear,
    meshgrid_coords,
)
from lushnerf_torch.matcher.dkm.resnet import BLOCKS, Encoder
from lushnerf_torch.utils.trace import span

DFN_DIM = 384
COARSE_SCALES = (32, 16)
REFINER_SCALES = ("16", "8", "4", "2", "1")


@dataclasses.dataclass(frozen=True)
class DKMDims:
    """The widths of a DKMv3 model that its code reads from the weights.

    resnet_width: the ResNet50's base width (torchvision: 64; stride s > 2
    has width * s channels).  proj_dim: the proj convs' output at 32 and
    16.  disp_emb: the displacement embedding of the refiners at 16, 8, 4,
    2, 1; hidden_mult: each refiner's hidden width over its input width
    (its depthwise first conv multiplies the channels).  A refiner's input
    is both images' features at its scale, the embedding and, at 16 / 8 /
    4, the (2r+1)^2 correlation window."""

    resnet_width: int = 64
    gp_dim: int = 256
    feat_dim: int = 256
    proj_dim: int = 512
    disp_emb: Tuple[int, ...] = (128, 64, 32, 16, 6)
    hidden_mult: Tuple[int, ...] = (1, 1, 1, 1, 2)

    def feature_channels(self) -> Dict[int, int]:
        """Channels the decoder sees at each scale (after proj at 32, 16)."""
        w = self.resnet_width
        return {1: 3, 2: w, 4: 4 * w, 8: 8 * w, 16: self.proj_dim, 32: self.proj_dim}


# The published DKMv3 factory's widths (gim/dkm/models/model_zoo/DKMv3.py:
# 1310-1449, SURVEY.md §2.2): gp_dim 256, feat_dim 256, proj 2048 -> 512
# and 1024 -> 512, displacement embeddings 128 / 64 / 32 / 16 / 6, refiner
# widths 2*512+128+15^2, 2*512+64+7^2, 2*256+32+5^2, 2*64+16 and, at full
# resolution, 2*3+6 in and 24 hidden.  The real checkpoint, when present,
# sets them through from_state_dict.
PUBLISHED_DIMS = DKMDims()
# a narrow model for the CPU tests (DFN_DIM stays 384: the code fixes it)
TINY_DIMS = DKMDims(resnet_width=8, gp_dim=16, feat_dim=16, proj_dim=16,
                    disp_emb=(8, 8, 4, 4, 2), hidden_mult=(1, 1, 1, 1, 2))


def state_shapes(dims: DKMDims) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of a DKMv3 model of these widths, by its
    state-dict name (the checkpoint's after its key cleanup)."""
    S: Dict[str, Tuple[int, ...]] = {}

    def conv(name, o, i, k=1, bias=True):
        S[f"{name}.weight"] = (o, i, k, k)
        if bias:
            S[f"{name}.bias"] = (o,)

    def bn(name, c):
        for p in ("weight", "bias", "running_mean", "running_var"):
            S[f"{name}.{p}"] = (c,)

    def rrb(name, i, o):
        conv(f"{name}.conv1", o, i)
        conv(f"{name}.conv2", o, o, 3)
        bn(f"{name}.bn", o)
        conv(f"{name}.conv3", o, o, 3)

    def dw_block(name, i, o):
        conv(f"{name}.0", o, 1, 5)
        bn(f"{name}.1", o)
        conv(f"{name}.3", o, o)

    w = dims.resnet_width
    conv("encoder.net.conv1", w, 3, 7, bias=False)
    bn("encoder.net.bn1", w)
    inp = w
    for layer, n_blocks in BLOCKS.items():
        planes = w * 2 ** (layer - 1)
        for b in range(n_blocks):
            p = f"encoder.net.layer{layer}.{b}"
            conv(f"{p}.conv1", planes, inp, bias=False)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3, bias=False)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", 4 * planes, planes, bias=False)
            bn(f"{p}.bn3", 4 * planes)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * planes, inp, bias=False)
                bn(f"{p}.downsample.1", 4 * planes)
            inp = 4 * planes
    conv("decoder.proj.32", dims.proj_dim, 32 * w)
    conv("decoder.proj.16", dims.proj_dim, 16 * w)
    e = "decoder.embedding_decoder"
    for s in COARSE_KEYS:
        conv(f"decoder.gps.{s}.pos_conv", dims.gp_dim, 2)
        conv(f"{e}.feat_input_modules.{s}", dims.feat_dim, dims.proj_dim)
        rrb(f"{e}.rrb_d.{s}", dims.gp_dim + dims.feat_dim, DFN_DIM)
        conv(f"{e}.cab.{s}.conv1", DFN_DIM, 2 * DFN_DIM)
        conv(f"{e}.cab.{s}.conv2", DFN_DIM, DFN_DIM)
        rrb(f"{e}.rrb_u.{s}", DFN_DIM, DFN_DIM)
        conv(f"{e}.terminal_module.{s}", 3, DFN_DIM)
    chans = dims.feature_channels()
    for s, emb, mult in zip(REFINER_SCALES, dims.disp_emb, dims.hidden_mult):
        r = REFINER_CFG[s]
        in_dim = 2 * chans[int(s)] + emb + ((2 * r + 1) ** 2 if r is not None else 0)
        hid = in_dim * mult
        p = f"decoder.conv_refiner.{s}"
        dw_block(f"{p}.block1", in_dim, hid)
        for i in range(HIDDEN_BLOCKS):
            dw_block(f"{p}.hidden_blocks.{i}", hid, hid)
        conv(f"{p}.out_conv", 3, hid)
        conv(f"{p}.disp_emb", emb, 2)
    return S


def random_state_dict(dims: DKMDims, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights of these widths from a seed (a CPU generator): convs
    as torch's default init (uniform within 1 / sqrt(fan_in)), BN scales
    and variances in [0.5, 1.5], shifts and means N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(seed)
    shapes = state_shapes(dims)
    bn_names = {k[: -len(".running_var")] for k in shapes if k.endswith(".running_var")}
    sd = {}
    for k, shape in shapes.items():
        mod, _, leaf = k.rpartition(".")
        if mod in bn_names:
            if leaf in ("weight", "running_var"):
                sd[k] = 0.5 + torch.rand(shape, generator=g)
            else:
                sd[k] = 0.1 * torch.randn(shape, generator=g)
        else:
            w = shapes[f"{mod}.weight"]
            bound = 1.0 / float(np.sqrt(np.prod(w[1:])))
            sd[k] = (2.0 * torch.rand(shape, generator=g) - 1.0) * bound
    return sd


class Decoder(nn.Module):
    def __init__(self, shapes, prefix: str = "decoder"):
        super().__init__()
        self.proj = nn.ModuleDict({s: Conv(shapes, f"{prefix}.proj.{s}") for s in COARSE_KEYS})
        self.gps = nn.ModuleDict({s: GP(shapes, f"{prefix}.gps.{s}") for s in COARSE_KEYS})
        self.embedding_decoder = DFN(shapes, f"{prefix}.embedding_decoder")
        self.conv_refiner = nn.ModuleDict({s: ConvRefiner(shapes, f"{prefix}.conv_refiner.{s}", s)
                                           for s in REFINER_SCALES})

    def forward(self, f1: Dict[int, torch.Tensor], f2: Dict[int, torch.Tensor],
                upsample: bool = False, dense_flow: Optional[torch.Tensor] = None,
                dense_certainty: Optional[torch.Tensor] = None):
        """Coarse-to-fine flow estimation over the pyramids: {scale:
        {"dense_flow" [B, 2, h, w], "dense_certainty" [B, 1, h, w]}}."""
        all_scales = ["32", "16", "8", "4", "2", "1"] if not upsample else ["8", "4", "2", "1"]
        sizes = {s: f1[s].shape[-2:] for s in f1}
        h, w = sizes[1]
        b = f1[1].shape[0]
        coarsest = int(all_scales[0])
        dev = f1[coarsest].device
        old_stuff = torch.zeros((b, DFN_DIM, *sizes[coarsest]), dtype=f1[coarsest].dtype,
                                device=dev)
        if not upsample:
            coords = meshgrid_coords(*sizes[coarsest], dev)
            dense_flow = coords.permute(2, 0, 1)[None].expand(b, 2, *sizes[coarsest])
            dense_certainty = 0.0
        else:
            dense_flow = interpolate_bilinear(dense_flow, sizes[coarsest])
            dense_certainty = interpolate_bilinear(dense_certainty, sizes[coarsest])

        corresps = {}
        for scale in all_scales:
            ins = int(scale)
            f1_s, f2_s = f1[ins], f2[ins]
            if scale in self.proj:
                f1_s, f2_s = self.proj[scale](f1_s), self.proj[scale](f2_s)
            if ins in COARSE_SCALES:
                old_stuff = interpolate_bilinear(old_stuff, sizes[ins])
                new_stuff = self.gps[scale](f1_s, f2_s)
                dense_flow, dense_certainty, old_stuff = self.embedding_decoder(
                    new_stuff, f1_s, old_stuff, scale)
            if scale in self.conv_refiner:
                delta_certainty, displacement = self.conv_refiner[scale](f1_s, f2_s, dense_flow)
                dense_flow = torch.stack((
                    dense_flow[:, 0] + ins * displacement[:, 0] / (4 * w),
                    dense_flow[:, 1] + ins * displacement[:, 1] / (4 * h),
                ), dim=1)
                dense_certainty = dense_certainty + delta_certainty
            corresps[ins] = {"dense_flow": dense_flow, "dense_certainty": dense_certainty}
            if scale != "1":
                dense_flow = interpolate_bilinear(dense_flow, sizes[ins // 2])
                dense_certainty = interpolate_bilinear(dense_certainty, sizes[ins // 2])
        return corresps


class DKM(nn.Module):
    """The DKMv3 matcher's weights: `encoder` (ResNet50) and `decoder`,
    frozen, under the checkpoint's names."""

    def __init__(self, shapes):
        super().__init__()
        shapes = {k: torch.Size(v) for k, v in shapes.items()}
        self.encoder = Encoder(shapes, "encoder")
        self.decoder = Decoder(shapes, "decoder")
        self.requires_grad_(False)

    @classmethod
    def from_state_dict(cls, state_dict: Dict[str, torch.Tensor]) -> "DKM":
        """A model with the widths of these weights, holding them (strict:
        every key must be one the model has, and every one of its keys
        given)."""
        model = cls({k: tuple(v.shape) for k, v in state_dict.items()})
        model.load_state_dict(state_dict, strict=True)
        return model

    def set_conv_dtype(self, dtype) -> None:
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        for m in self.modules():
            if isinstance(m, Conv):
                m.compute_dtype = dtype


def dkm_match_from_pyramids(model: DKM, pyr_q, pyr_s):
    """One direction (query -> support), both passes, for a batch of B
    pairs whose encoder pyramids are given ({stride: [B, C, h, w]}).
    Returns (flow [B, hs, ws, 2] in [-1, 1], certainty [B, hs, ws]).

    The decoder couples nothing across the batch (convs, frozen BN, a GP
    solve per image), so this is the query half of the symmetric match;
    LuSh keeps only that half (run_lushnerf.py:757-770) and matches every
    ordered pair, so one direction per pair is the work it reads."""
    hs, ws = pyr_q[1].shape[-2:]
    corresps = model.decoder(pyr_q, pyr_s)
    low_res_certainty = interpolate_bilinear(corresps[16]["dense_certainty"], (hs, ws))
    low_res_certainty = 0.5 * low_res_certainty * (low_res_certainty < 0)
    corresps = model.decoder(pyr_q, pyr_s, upsample=True,
                             dense_flow=corresps[1]["dense_flow"],
                             dense_certainty=corresps[1]["dense_certainty"])
    flow = corresps[1]["dense_flow"].permute(0, 2, 3, 1)
    certainty = torch.sigmoid(corresps[1]["dense_certainty"] - low_res_certainty)[:, 0]
    wrong = (flow.abs() > 1).any(dim=-1)
    certainty = torch.where(wrong, torch.zeros_like(certainty), certainty)
    return flow.clamp(-1, 1), certainty


def dkm_match(model: DKM, im0: torch.Tensor, im1: torch.Tensor, hs: int = 640, ws: int = 1120):
    """RegressionMatcher.match (symmetric, upsample_preds) for one pair.

    im0, im1: [3, H, W] in [0, 1] (no ImageNet normalisation: the
    reference's match path feeds raw tensors to the encoder).  One encoder
    pass over [query; support] serves both decoder passes (the second, at
    the same resolution, would recompute the same pyramid).  Returns
    (warp [hs, 2*ws, 4], certainty [hs, 2*ws])."""
    query = interpolate_bilinear(im0[None], (hs, ws))
    support = interpolate_bilinear(im1[None], (hs, ws))
    pyramid = model.encoder(torch.cat([query, support]))
    swapped = {s: torch.cat([f[1:], f[:1]]) for s, f in pyramid.items()}
    flow, certainty = dkm_match_from_pyramids(model, pyramid, swapped)
    query_coords = meshgrid_coords(hs, ws, im0.device)
    q_warp = torch.cat([query_coords, flow[0]], dim=-1)
    s_warp = torch.cat([flow[1], query_coords], dim=-1)
    warp = torch.cat([q_warp, s_warp], dim=1)  # [hs, 2ws, 4]
    return warp, torch.cat([certainty[0], certainty[1]], dim=1)


@dataclasses.dataclass
class DKMMatcher:
    """The Matcher the trainer's rematch calls, running the DKMv3 port.

    max_columns: columns kept per pair, spread by linspace (the reference
    keeps all hs * ws columns; the train-time draw of 32 columns is
    uniform either way).  pair_batch: ordered pairs per decoder call in
    match_many.  conv_dtype: the convs' input precision, float32 or
    bfloat16 (f32 accumulation).  Runs under `full_f32` (no TF32)."""

    model: DKM
    hs: int = 640
    ws: int = 1120
    max_columns: int = 65536
    pair_batch: int = 2
    conv_dtype: str = "float32"

    def __post_init__(self):
        self.model.eval()
        self.model.set_conv_dtype(self.conv_dtype)

    @property
    def device(self) -> torch.device:
        return self.model.encoder.net.conv1.weight.device

    @classmethod
    def from_pretrained(cls, ckpt_path: Optional[str] = None, device="cuda", **kw) -> "DKMMatcher":
        """From a checkpoint (`gim_dkm_100h.ckpt`) at ckpt_path or
        $LUSHNERF_DKM_CKPT; FileNotFoundError when there is none."""
        from lushnerf_torch.matcher.dkm.convert import load_checkpoint

        ckpt_path = ckpt_path or os.environ.get("LUSHNERF_DKM_CKPT")
        if not ckpt_path or not os.path.exists(ckpt_path):
            raise FileNotFoundError(
                "DKM checkpoint not found; set LUSHNERF_DKM_CKPT or pass "
                "ckpt_path (reference weights: gim_dkm_100h.ckpt)"
            )
        return cls(model=DKM.from_state_dict(load_checkpoint(ckpt_path)).to(device), **kw)

    def _to_kpts(self, matches: torch.Tensor, cert: torch.Tensor, H: int, W: int):
        """[P, 4] normalised (x0, y0, x1, y1) + [P] certainty -> (kpts0,
        kpts1, cert) in the image's pixel coords, max_columns of them by
        linspace, as numpy f32 (W * (m + 1) / 2 in f32, as the reference)."""
        if self.max_columns and len(cert) > self.max_columns:
            idx = np.linspace(0, len(cert) - 1, self.max_columns).astype(int)
            idx = torch.from_numpy(idx).to(cert.device)
            matches, cert = matches[idx], cert[idx]
        kpts0 = torch.stack([W * (matches[:, 0] + 1) / 2, H * (matches[:, 1] + 1) / 2], -1)
        kpts1 = torch.stack([W * (matches[:, 2] + 1) / 2, H * (matches[:, 3] + 1) / 2], -1)
        return kpts0.cpu().numpy(), kpts1.cpu().numpy(), cert.cpu().numpy()

    def _image(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1), np.float32)).to(
            self.device)

    def match(self, img0: np.ndarray, img1: np.ndarray):
        """img: [H, W, 3] f32 in [0, 1].  The symmetric match; LuSh takes
        the first ws columns (the query half) and converts them to pixel
        coords (run_lushnerf.py:757-770).  Returns numpy (kpts0 [P, 2],
        kpts1 [P, 2], certainty [P])."""
        with torch.inference_mode(), full_f32():
            warp, certainty = dkm_match(self.model, self._image(img0), self._image(img1),
                                        self.hs, self.ws)
            H, W = img0.shape[:2]
            return self._to_kpts(warp[:, : self.ws].reshape(-1, 4),
                                 certainty[:, : self.ws].reshape(-1), H, W)

    def encode(self, images: np.ndarray, views: Sequence[int]) -> Dict[int, Dict[int, torch.Tensor]]:
        """The encoder pyramid of each view, at (hs, ws), on the device."""
        return {vi: self.model.encoder(interpolate_bilinear(self._image(images[vi])[None],
                                                            (self.hs, self.ws)))
                for vi in views}

    def match_many(self, images: np.ndarray, pairs):
        """Match a list of ordered (k, v) pairs over a view set.

        images: [V, H, W, 3] f32.  Returns numpy (kpts [n_pairs, P, 4],
        certainty [n_pairs, P]): what per-pair match() gives for the query
        direction, from one encoder pass a view (cached on the device) and
        single-direction decoder calls of pair_batch pairs.

        Spans: one `dkm.encode` over the views' encoder passes, ending on
        its one sync (`sync.dkm_encode`), and a `dkm.decode` a pair batch
        (its decoder call and its tables' copy to the host, which waits on
        the device)."""
        pairs = list(pairs)
        H, W = images.shape[1:3]
        with torch.inference_mode(), full_f32():
            with span("dkm.encode"):
                pyr = self.encode(images, sorted({k for k, _ in pairs} | {v for _, v in pairs}))
                with span("sync.dkm_encode"):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            coords = meshgrid_coords(self.hs, self.ws, self.device)
            kpts_l, cert_l = [], []
            pb = max(1, self.pair_batch)
            for lo in range(0, len(pairs), pb):
                chunk = pairs[lo: lo + pb]
                with span("dkm.decode"):
                    pyr_q = {s: torch.cat([pyr[k][s] for k, _ in chunk])
                             for s in pyr[chunk[0][0]]}
                    pyr_s = {s: torch.cat([pyr[v][s] for _, v in chunk])
                             for s in pyr[chunk[0][0]]}
                    flow, cert = dkm_match_from_pyramids(self.model, pyr_q, pyr_s)
                    for bi in range(len(chunk)):
                        matches = torch.cat([coords, flow[bi]], dim=-1).reshape(-1, 4)
                        k0, k1, c = self._to_kpts(matches, cert[bi].reshape(-1), H, W)
                        kpts_l.append(np.concatenate([k0, k1], -1))
                        cert_l.append(c)
        return np.stack(kpts_l), np.stack(cert_l)
