"""Fused NeRF-MLP forward: the CUDA kernel's wrapper, its plain PyTorch
version, and a launch counter.

The kernel (`lushnerf_torch/csrc/nerf_mlp_fwd.cu`) computes, per point,
positional encoding + the 8x256 scene MLP (skip at layer 4) + alpha /
feature / views / rgb heads, and writes raw [rgb, alpha].  It replaces the
Pallas TPU kernel `_fwd_kernel` of `lushnerf_tpu/ops/fused/nerf_mlp.py`
(forward output only; the backward kernels come with training).

`nerf_mlp_fwd` is the wrapper: on a CPU tensor it runs `nerf_mlp_fwd_plain`,
on a CUDA tensor it launches the kernel or raises.  `launches` counts
kernel launches and nothing else.

compute_dtype:
  'float32'  -- IEEE f32 products and sums (no TF32).
  'bfloat16' -- every matmul input (PE, activations, weights) rounded to
                bf16, f32 accumulation, f32 bias and relu: the rounding
                points of the TPU kernel's bfloat16 mode.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from lushnerf_torch.ops.encoding import posenc
from lushnerf_torch.ops.fused import build

WIDTH = 256  # the kernel's compiled width
PE_MAX = 128  # kx + kd
XD_CH = 8  # packed input lanes: 0:3 xyz, 3:6 viewdir, 6:8 zero
OUT_CH = 4  # output lanes: 0:3 rgb, 3 alpha
# offsets into the f32 blob (mirrors FP_* in the CUDA source)
FP_BF = 8 * WIDTH
FP_BV = FP_BF + WIDTH
FP_BA = FP_BV + WIDTH // 2
FP_BR = FP_BA + 4
FP_WA = FP_BR + 4
FP_WR = FP_WA + WIDTH
FP_NUMEL = FP_WR + 3 * (WIDTH // 2)

COMPUTE_DTYPES = ("float32", "bfloat16")

# Kernel launches since the last reset (set it to 0 to start counting).
launches = 0


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def pe_widths(mlp_cfg) -> Tuple[int, int]:
    """(kx, kd): the PE channel counts padded to the kernel's K-chunk."""
    return _round32(mlp_cfg.input_ch), _round32(mlp_cfg.input_ch_views)


def supports(mlp_cfg, render_cfg) -> bool:
    """The MLP family the 'cuda' backend sends to the fused path, the same
    as the JAX package's: depth 8, width a multiple of 128, skip at layer
    4, viewdirs on, both PEs within 128 channels.  On the card, a member the
    compiled kernel does not cover (any width but 256) raises."""
    return (
        mlp_cfg.depth == 8
        and mlp_cfg.width % 128 == 0
        and mlp_cfg.width >= 128
        and tuple(mlp_cfg.skips) == (4,)
        and mlp_cfg.use_viewdirs
        and not mlp_cfg.rgb_only
        and mlp_cfg.input_ch + mlp_cfg.input_ch_views <= PE_MAX
    )


def check_kernel_family(mlp_cfg, compute_dtype: str, num_freqs_x: int,
                        num_freqs_d: int) -> None:
    """Raises ValueError unless the compiled kernel covers this MLP, PE and
    compute dtype (width 256, padded PEs within 128 channels)."""
    kx, kd = pe_widths(mlp_cfg)
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"nerf_mlp_fwd: compute_dtype {compute_dtype!r} not in {COMPUTE_DTYPES}")
    if not (mlp_cfg.depth == 8 and tuple(mlp_cfg.skips) == (4,) and mlp_cfg.use_viewdirs
            and not mlp_cfg.rgb_only):
        raise ValueError("nerf_mlp_fwd: the kernel covers depth 8, skip at 4, viewdirs on")
    if mlp_cfg.width != WIDTH:
        raise ValueError(f"nerf_mlp_fwd: the kernel is compiled for width {WIDTH}, "
                         f"not {mlp_cfg.width}")
    if kx + kd > PE_MAX or 3 + 6 * num_freqs_x != mlp_cfg.input_ch \
            or 3 + 6 * num_freqs_d != mlp_cfg.input_ch_views:
        raise ValueError(f"nerf_mlp_fwd: PE of {num_freqs_x}/{num_freqs_d} frequencies "
                         f"into {mlp_cfg.input_ch}/{mlp_cfg.input_ch_views} MLP inputs "
                         f"is outside the kernel's {PE_MAX} padded channels")


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def nerf_mlp_fwd_plain(mlp, xd: torch.Tensor, compute_dtype: str = "float32",
                       num_freqs_x: int = 10, num_freqs_d: int = 4) -> torch.Tensor:
    """The kernel's function in PyTorch ops, rounding where it rounds.

    mlp: a `NeRFMLP` of the supported family; xd: [P, 8] float32.
    Returns raw [P, 4] = [rgb, alpha].  On CUDA set
    torch.backends.cuda.matmul.allow_tf32 = False, or the f32 products
    lose precision.
    """
    if compute_dtype == "bfloat16":
        def dot(a, w):
            return a.bfloat16().float() @ w.bfloat16().float().T
    else:
        def dot(a, w):
            return a @ w.T
    in_ch = mlp.cfg.input_ch
    W = mlp.cfg.width
    x_pe = posenc(xd[:, 0:3], num_freqs_x)
    d_pe = posenc(xd[:, 3:6], num_freqs_d)
    pts = mlp.pts_linears
    h = x_pe
    for i in range(5):
        h = torch.relu(dot(h, pts[i].weight) + pts[i].bias)
    w5 = pts[5].weight
    h = torch.relu(dot(x_pe, w5[:, :in_ch]) + dot(h, w5[:, in_ch:]) + pts[5].bias)
    for i in (6, 7):
        h = torch.relu(dot(h, pts[i].weight) + pts[i].bias)
    alpha = dot(h, mlp.alpha_linear.weight) + mlp.alpha_linear.bias
    feat = dot(h, mlp.feature_linear.weight) + mlp.feature_linear.bias
    wv = mlp.views_linears[0].weight
    hv = torch.relu(dot(feat, wv[:, :W]) + dot(d_pe, wv[:, W:]) + mlp.views_linears[0].bias)
    rgb = dot(hv, mlp.rgb_linear.weight) + mlp.rgb_linear.bias
    return torch.cat([rgb, alpha], dim=-1)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------


@torch.no_grad()
def pack_params(mlp, compute_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's parameter blobs (layout in the CUDA source's header):
    the weight blob in the compute dtype, the f32 blob of biases and heads.

    Packed once per parameter version: the result is cached on the module
    and rebuilt when a parameter is replaced or changed in place.
    """
    params = list(mlp.parameters())
    key = (compute_dtype, tuple((p.data_ptr(), p._version) for p in params))
    cached = getattr(mlp, "_nerf_mlp_fwd_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    cfg = mlp.cfg
    in_ch, W = cfg.input_ch, cfg.width
    kx, kd = pe_widths(cfg)
    bf16 = compute_dtype == "bfloat16"

    def padk(w, k):
        return F.pad(w, (0, k - w.shape[1]))

    pts = [lin.weight for lin in mlp.pts_linears]
    w5 = pts[5]
    wv = mlp.views_linears[0].weight
    mats = [
        padk(pts[0], kx), pts[1], pts[2], pts[3], pts[4],
        torch.cat([padk(w5[:, :in_ch], kx), w5[:, in_ch:]], dim=1),
        pts[6], pts[7], mlp.feature_linear.weight,
        torch.cat([wv[:, :W], padk(wv[:, W:], kd)], dim=1),
    ]
    wdt = torch.bfloat16 if bf16 else torch.float32
    w = torch.cat([m.reshape(-1) for m in mats]).to(wdt).contiguous()

    def head(t):
        return t.bfloat16().float() if bf16 else t

    fp = torch.zeros(FP_NUMEL, dtype=torch.float32, device=w.device)
    fp[0:FP_BF] = torch.cat([lin.bias for lin in mlp.pts_linears])
    fp[FP_BF:FP_BV] = mlp.feature_linear.bias
    fp[FP_BV:FP_BA] = mlp.views_linears[0].bias
    fp[FP_BA] = mlp.alpha_linear.bias[0]
    fp[FP_BR:FP_BR + 3] = mlp.rgb_linear.bias
    fp[FP_WA:FP_WR] = head(mlp.alpha_linear.weight[0])
    fp[FP_WR:] = head(mlp.rgb_linear.weight).reshape(-1)
    packed = (w, fp)
    mlp._nerf_mlp_fwd_pack = (key, packed)
    return packed


def _lib() -> ctypes.CDLL:
    lib = build.load("nerf_mlp_fwd")
    if not getattr(lib, "_lushnerf_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nerf_mlp_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.nerf_mlp_fwd.restype = ci
        lib.nerf_mlp_fwd_w_numel.argtypes = [ci, ci]
        lib.nerf_mlp_fwd_w_numel.restype = ctypes.c_longlong
        lib.nerf_mlp_fwd_fp_numel.argtypes = []
        lib.nerf_mlp_fwd_fp_numel.restype = ctypes.c_longlong
        lib.nerf_mlp_fwd_error_string.argtypes = [ci]
        lib.nerf_mlp_fwd_error_string.restype = ctypes.c_char_p
        if lib.nerf_mlp_fwd_fp_numel() != FP_NUMEL:
            raise RuntimeError("nerf_mlp_fwd: f32 blob layout differs from the CUDA source")
        lib._lushnerf_typed = True
    return lib


def _needs_grad(mlp, xd: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (
        xd.requires_grad or any(p.requires_grad for p in mlp.parameters())
    )


def nerf_mlp_fwd(mlp, xd: torch.Tensor, compute_dtype: str = "float32",
                 num_freqs_x: int = 10, num_freqs_d: int = 4) -> torch.Tensor:
    """Raw [P, 4] = [rgb, alpha] of the scene MLP at packed points xd [P, 8].

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error
    (no gradient yet: the backward kernel comes with training, so call it
    under torch.no_grad() or with parameters that need no grad).
    """
    if xd.device.type == "cpu":
        return nerf_mlp_fwd_plain(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d)
    if xd.device.type != "cuda":
        raise ValueError(f"nerf_mlp_fwd: unsupported device {xd.device}")
    if _needs_grad(mlp, xd):
        raise NotImplementedError(
            "nerf_mlp_fwd: the CUDA kernel has no backward yet; run under torch.no_grad()"
        )
    check_kernel_family(mlp.cfg, compute_dtype, num_freqs_x, num_freqs_d)
    if xd.dtype != torch.float32 or xd.dim() != 2 or xd.shape[1] != XD_CH:
        raise ValueError(f"nerf_mlp_fwd: xd must be float32 [P, {XD_CH}], got "
                         f"{xd.dtype} {tuple(xd.shape)}")
    kx, kd = pe_widths(mlp.cfg)
    xd = xd.contiguous()
    w, fp = pack_params(mlp, compute_dtype)
    if w.device != xd.device:
        raise ValueError(f"nerf_mlp_fwd: params on {w.device}, points on {xd.device}")
    P = xd.shape[0]
    out = torch.empty((P, OUT_CH), dtype=torch.float32, device=xd.device)
    if P == 0:
        return out
    lib = _lib()
    if w.numel() != lib.nerf_mlp_fwd_w_numel(kx, kd):
        raise RuntimeError("nerf_mlp_fwd: weight blob layout differs from the CUDA source")
    for t in (xd, w, fp, out):
        if t.data_ptr() % 16:
            raise ValueError("nerf_mlp_fwd: tensors must be 16-byte aligned")
    stream = torch.cuda.current_stream(xd.device).cuda_stream
    with torch.cuda.device(xd.device):
        rc = lib.nerf_mlp_fwd(
            xd.data_ptr(), w.data_ptr(), fp.data_ptr(), out.data_ptr(), P, kx, kd,
            num_freqs_x, num_freqs_d, int(compute_dtype == "bfloat16"), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"nerf_mlp_fwd: CUDA error {rc} ({lib.nerf_mlp_fwd_error_string(rc).decode()})"
        )
    global launches
    launches += 1
    return out


def eval_points_fused(mlp, mlp_cfg, render_cfg, pts: torch.Tensor,
                      viewdirs: torch.Tensor) -> torch.Tensor:
    """Drop-in for renderer.eval_points on the MLP family of `supports`.

    pts: [R, S, 3]; viewdirs: [R, 3].  Returns raw [R, S, 4].  Only the
    packed [P, 8] (xyz, dir) array goes in; the PE happens in the kernel.
    """
    if not supports(mlp_cfg, render_cfg):
        raise NotImplementedError(
            "fused kernel supports the reference MLP family only "
            f"(depth={mlp_cfg.depth}, width={mlp_cfg.width}, skips={mlp_cfg.skips})"
        )
    R, S = pts.shape[0], pts.shape[1]
    P = R * S
    x = pts.reshape(P, 3)
    d = viewdirs[:, None, :].expand(R, S, 3).reshape(P, 3)
    xd = torch.cat([x, d, x.new_zeros(P, XD_CH - 6)], dim=-1).float()
    raw = nerf_mlp_fwd(mlp, xd, render_cfg.mlp_compute_dtype,
                       render_cfg.multires, render_cfg.multires_views)
    return raw.reshape(R, S, OUT_CH)
