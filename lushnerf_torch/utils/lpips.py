"""LPIPS perceptual metric in torch (AlexNet trunk + linear calibration).

A port of lushnerf_tpu/utils/lpips.py, which mirrors the vendored
reference metric (lpips/lpips.py:140-240 + lpips/pretrained_networks.py):
scale inputs by the fixed shift/scale, run the AlexNet feature trunk,
unit-normalise each feature map on the channel axis, weight squared
differences with the 1x1 linear calibration heads, average over space,
and sum over the five stages.  It runs on the images' device, with TF32
off (`full_f32`, as the DKM matcher: cuDNN's TF32 default would move the
card's value ~1e-3 from the CPU's).

Weight sourcing: the trunk is torchvision's pretrained AlexNet
(`features.{0,3,6,8,10}`) and the heads are the LPIPS v0.1 linear weights
(`lin{i}.model.1.weight`).  `load_weights` reads both with
`torch.load(..., weights_only=True)` from `LPIPS_ALEX_PATH` and
`LPIPS_LINEAR_PATH` (env vars or explicit arguments); without
`LPIPS_LINEAR_PATH` it looks for the heads where the reference repository
vendors them, `lpips/weights/v0.1/alex.pth`, under this repository's root.
Without the trunk, `lpips()` raises `LPIPSUnavailable` and callers record
the metric as unavailable; with the trunk but no heads it warns loudly and
uses uniform heads, whose values are not the published metric's.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from lushnerf_torch.matcher.dkm.nn import full_f32
from lushnerf_torch.models.lushnerf import resolve_device

# LPIPS input normalization constants (lpips/lpips.py ScalingLayer).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature config: (out_ch, kernel, stride, padding), with maxpools
# between stages as in torchvision.models.alexnet.features.
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_STAGE_CHANNELS = [64, 192, 384, 256, 256]
_ALEX_CONV_IDS = [0, 3, 6, 8, 10]  # torchvision alexnet.features indices

# The reference repository vendors the LPIPS v0.1 heads at this path of
# its checkout (the only LPIPS weight file it ships; the AlexNet trunk is
# a torchvision download): looked for under this repository's root.
_REFERENCE_LINEAR_PATH = str(Path(__file__).resolve().parents[2]
                             / "lpips" / "weights" / "v0.1" / "alex.pth")


class LPIPSUnavailable(RuntimeError, ValueError):
    """The weights LPIPS needs are missing.  A RuntimeError as the JAX
    package's; also a ValueError, which `compute_img_metric` raised for
    "lpips" before the metric was ported and which
    `tests/test_torch_trainer.py::test_compute_img_metric_matches_jax`
    still expects where no weights are found."""


_cache: Dict[str, Any] = {}


def _default_linear_path() -> Optional[str]:
    p = os.environ.get("LPIPS_LINEAR_PATH")
    if p:
        return p
    if os.path.exists(_REFERENCE_LINEAR_PATH):
        return _REFERENCE_LINEAR_PATH
    return None


def status() -> Dict[str, Any]:
    """Which LPIPS weight artifacts are present, distinctly.

    trunk: pretrained AlexNet features (a torchvision download: the
    artifact missing offline).  heads: LPIPS v0.1 linear calibration
    weights (vendored by the reference).
    """
    alex_path = os.environ.get("LPIPS_ALEX_PATH")
    linear_path = _default_linear_path()
    return {
        "trunk_path": alex_path,
        "trunk_available": bool(alex_path and os.path.exists(alex_path)),
        "heads_path": linear_path,
        "heads_available": bool(linear_path and os.path.exists(linear_path)),
    }


def unavailable_reason() -> Optional[str]:
    """One-line human explanation for eval logs, or None if computable."""
    s = status()
    if s["trunk_available"] and s["heads_available"]:
        return None
    missing = []
    if not s["trunk_available"]:
        missing.append(
            "pretrained AlexNet trunk (torchvision alexnet weights; "
            "set LPIPS_ALEX_PATH)"
        )
    if not s["heads_available"]:
        missing.append("LPIPS v0.1 linear heads (set LPIPS_LINEAR_PATH)")
    return "LPIPS unavailable — missing: " + "; ".join(missing)


def load_weights(alex_path: Optional[str] = None, linear_path: Optional[str] = None,
                 device: str | torch.device = "cuda") -> Dict[str, Any]:
    """The AlexNet trunk ({"convs": [(w [out, in, kh, kw], b)] x 5}) and the
    heads ({"lins": [[1, C]] x 5}) as f32 tensors on `device` (the card
    unless the caller asks for the CPU)."""
    alex_path = alex_path or os.environ.get("LPIPS_ALEX_PATH")
    linear_path = linear_path or _default_linear_path()
    if not alex_path or not os.path.exists(alex_path):
        raise LPIPSUnavailable(
            "pretrained AlexNet trunk weights not available (set LPIPS_ALEX_PATH)"
        )

    device = resolve_device(device)

    def f32(t):
        return t.to(device=device, dtype=torch.float32)

    sd = torch.load(alex_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    convs = [(f32(sd[f"features.{i}.weight"]), f32(sd[f"features.{i}.bias"]))
             for i in _ALEX_CONV_IDS]
    if linear_path and os.path.exists(linear_path):
        lsd = torch.load(linear_path, map_location="cpu", weights_only=True)
        lins = [f32(lsd[f"lin{i}.model.1.weight"][:, :, 0, 0]) for i in range(5)]  # [1, C]
    else:
        # uniform calibration heads are NOT the published LPIPS metric:
        # scores compare within a run, not against the paper's
        warnings.warn(
            "LPIPS linear calibration weights not found "
            "(set LPIPS_LINEAR_PATH); falling back to uniform per-channel "
            "weights — values are not comparable to published LPIPS numbers",
            stacklevel=2,
        )
        lins = [torch.full((1, c), 1.0 / c, device=device) for c in _STAGE_CHANNELS]
    return {"convs": convs, "lins": lins}


def alexnet_features(params, x: torch.Tensor):
    """x: [N, 3, H, W] normalized.  Returns the 5 stage feature maps."""
    feats = []
    for i, ((w, b), (_, _, s, p)) in enumerate(zip(params["convs"], _ALEX_CONVS)):
        x = torch.relu(F.conv2d(x, w, b, stride=s, padding=p))
        feats.append(x)
        if i in (0, 1):  # maxpool after stages 1 and 2
            x = F.max_pool2d(x, 3, 2)
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(f**2, dim=1, keepdim=True))
    return f / (norm + eps)


def lpips_pair(params, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """im1, im2: [H, W, 3] in [-1, 1], on the weights' device.  Returns the
    scalar LPIPS distance."""
    shift = torch.tensor(_SHIFT, device=im1.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=im1.device)[None, :, None, None]

    def prep(im):
        return ((im.permute(2, 0, 1)[None] - shift) / scale).float()

    total = im1.new_zeros((), dtype=torch.float32)
    with full_f32():
        f1 = alexnet_features(params, prep(im1))
        f2 = alexnet_features(params, prep(im2))
        for a, b, lin in zip(f1, f2, params["lins"]):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2  # [1, C, H, W]
            weighted = torch.einsum("nchw,oc->nohw", d, lin)
            total = total + torch.mean(weighted, dim=(2, 3))[0, 0]
    return total


def _params_on(device: torch.device):
    key = f"params@{device}"
    if key not in _cache:
        _cache[key] = load_weights(device=device)
    return _cache[key]


def lpips(im1, im2) -> torch.Tensor:
    """im1, im2: [H, W, 3] in [0, 1] (mapped to [-1, 1] as the reference's
    compute_img_metric does), tensors on any device or arrays."""
    im1 = torch.as_tensor(im1)
    im2 = torch.as_tensor(im2, device=im1.device)
    params = _params_on(im1.device)
    a = torch.clamp(im1 * 2 - 1, -1, 1)
    b = torch.clamp(im2 * 2 - 1, -1, 1)
    return lpips_pair(params, a, b)


def available() -> bool:
    try:
        _params_on(torch.device("cpu"))
        return True
    except Exception:
        return False
