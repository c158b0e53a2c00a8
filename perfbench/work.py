"""The yardstick's arithmetic: the model work of the scene MLPs, the bytes
their kernels must move at least, and the card's peaks.

Frozen copies, so that a roofline reads the same work whatever implements
it.  `mlp_macs` is the port's `chip_smoke.mlp_macs` (the unpadded scene
MLP; the PE is not counted); the peaks are NVIDIA's H100 SXM data sheet,
dense, without sparsity, at the full 700 W.

Conventions:
  * work is the scene MLPs' (coarse and fine) model work from the shapes:
    2 x mlp_macs FLOP a point a pass.  The SND noise MLP and the RBK MLPs
    are left out (together under 0.2% of a step's multiply-adds).
  * the backward's work is twice the forward's (the input gradient and the
    weight gradient); recomputation is time, not work.
  * bytes count each input read once and each output written once: a
    forward reads the packed point (8 f32) and writes raw rgb + alpha (4
    f32); a backward reads the point and the cotangent and writes the
    point's gradient.  Weights are read once and, in the backward, their
    gradients written once.  A stash is not counted.
  * peaks: 989 TFLOP/s for bf16, 495 TFLOP/s for 32-bit floats (TF32, the
    data sheet's tensor-core rate; the port's f32 kernels already pass the
    67 TFLOP/s of the non-tensor cores), 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
POINT_IN_BYTES = 8 * 4  # the packed point: xyz, view direction, two zero lanes
POINT_OUT_BYTES = 4 * 4  # raw rgb and alpha


def mlp_macs(width: int, in_ch: int = 63, d_ch: int = 27) -> int:
    """Multiply-adds a point of the unpadded scene MLP at `width` (depth 8,
    skip at layer 4, feature and alpha heads, a views layer width / 2 wide,
    rgb head); in_ch / d_ch PE inputs.  593,408 at 256 with 63 / 27."""
    w = width
    return (in_ch * w + 7 * w * w + (in_ch + w) * w + w + (w + d_ch) * (w // 2)
            + 3 * (w // 2))


def mlp_params(width: int, in_ch: int = 63, d_ch: int = 27) -> int:
    """Weights and biases of the scene MLP: its multiply-adds a point plus
    one bias an output."""
    w = width
    return mlp_macs(width, in_ch, d_ch) + 8 * w + w + 1 + w // 2 + 3


def pe_channels(num_freqs: int) -> int:
    return 3 + 2 * 3 * num_freqs


def flop_per_point(width: int, multires: int, multires_views: int) -> float:
    """FLOP a point of one forward pass."""
    return 2.0 * mlp_macs(width, pe_channels(multires), pe_channels(multires_views))


def train_points(n_rand: int, sub_rays: int, n_samples: int, n_importance: int) -> int:
    """Scene-MLP points of one iteration: each of n_rand rays splits into
    sub_rays RBK sub-rays; the coarse MLP sees n_samples points of each and
    the fine MLP n_samples + n_importance."""
    rays = n_rand * sub_rays
    return rays * n_samples + rays * (n_samples + n_importance)


def view_points(height: int, width: int, n_samples: int, n_importance: int) -> int:
    """Scene-MLP points of one rendered view (no RBK at render time)."""
    return height * width * (2 * n_samples + n_importance)


def fwd_bytes(points: int, n_params: int) -> float:
    return points * (POINT_IN_BYTES + POINT_OUT_BYTES) + 4.0 * n_params


def bwd_bytes(points: int, n_params: int) -> float:
    # read the point and the cotangent, write the point's gradient; read the
    # weights, write their gradients
    return points * (2 * POINT_IN_BYTES + POINT_OUT_BYTES) + 8.0 * n_params


def roofline_share(flop: float, nbytes: float, seconds: float, dtype: str) -> float:
    """Per cent of the least time the card could take, the larger of
    flop / peak and bytes / HBM bandwidth, against `seconds`."""
    least = max(flop / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
    return 100.0 * least / seconds
