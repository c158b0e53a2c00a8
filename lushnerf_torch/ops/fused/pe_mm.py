"""The fused NeRF-MLP forward split in two, for the kernel-cost split of
`lushnerf_torch/scripts/tune_kernel.py`: the packed positional encoding
alone (`pe_only`) and the scene MLP alone on a pre-encoded PE (`mm_only`),
with their plain PyTorch versions and launch counters.

Both kernels live in `lushnerf_torch/csrc/nerf_pe_mm.cu`.  `pe_only`
replaces the Pallas TPU kernel `pe_kernel` of `scripts/tune_kernel.py`
(`_pe_forward` of `lushnerf_tpu/ops/fused/nerf_mlp.py`), `mm_only` its
`mm_kernel` (`_fwd_activations` in bfloat16); `mm_only` runs the bf16
forward kernel's design (`csrc/nerf_mlp_fwd_sm90.cuh`) with its PE loaded,
on the same weight blob and grid geometry.

The packed PE layout is the JAX package's at the tuning script's fixed
10 xyz and 4 viewdir frequencies: one 128-lane row per point, lanes [0, 63)
the xyz PE and [63, 90) the viewdir PE, the rest zero; each trig lane is
sin(a + phase) with the float32 phase 0 or pi/2, as the TPU kernel computes
it.  `mm_only` takes an MLP whose inputs are that layout (input_ch 63,
input_ch_views 27) and raises for any other.  The tables below are this
package's copy of the JAX package's (`_pe_lane_tables`, `_pe_consts_np`,
`pe_out_dims`).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises.  `launches_pe_only` and
`launches_mm_only` count launches (plain integers: set them to 0 to start
counting; each wrapper adds one where it launches, and nowhere else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import nerf_mlp as fused

LANES = 128  # the packed PE row and the matmul-only output row
PE_ROWS = 16
# the frequencies of the packed PE, fixed as in the JAX tuning script (and
# in nerf_pe_mm.cu)
NUM_FREQS_X, NUM_FREQS_D = 10, 4
HALF_PI = float(np.pi / 2)

# Kernel launches since they were last set to 0.
launches_pe_only = 0
launches_mm_only = 0


def _pe_lane_tables(num_freqs: int, src_lo: int, lane_lo: int, sel, freq, idm,
                    trig, phase, dims: int = 3) -> int:
    """Fill the selection and per-lane rows of one PE block at lane offset
    `lane_lo`, in the reference embedder's order [x, sin(2^0 x),
    cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    out_dim = dims + 2 * num_freqs * dims
    if lane_lo + out_dim > LANES:
        raise ValueError(f"PE block of {out_dim} lanes at {lane_lo} exceeds {LANES} lanes")
    for l in range(out_dim):
        if l < dims:
            c, f, kind = l, 1.0, "id"
        else:
            j, r = divmod(l - dims, 2 * dims)
            c, f = r % dims, float(2.0 ** j)
            kind = "sin" if r < dims else "cos"
        lane = lane_lo + l
        sel[src_lo + c, lane] = 1.0
        freq[0, lane] = f
        if kind == "id":
            idm[0, lane] = 1.0
        else:
            trig[0, lane] = 1.0
            phase[0, lane] = 0.0 if kind == "sin" else HALF_PI
    return out_dim


def pe_out_dims(num_freqs_x: int, num_freqs_d: int) -> Tuple[int, int]:
    return 3 + 6 * num_freqs_x, 3 + 6 * num_freqs_d


@functools.lru_cache(maxsize=None)
def _pe_consts_np(num_freqs_x: int, num_freqs_d: int) -> np.ndarray:
    """[16, 128] float32: rows 0:8 select each lane's input channel, then
    the frequency, identity-mask, trig-mask and phase rows."""
    sel = np.zeros((fused.XD_CH, LANES), np.float32)
    freq = np.zeros((1, LANES), np.float32)
    idm = np.zeros((1, LANES), np.float32)
    trig = np.zeros((1, LANES), np.float32)
    phase = np.zeros((1, LANES), np.float32)
    dx = _pe_lane_tables(num_freqs_x, 0, 0, sel, freq, idm, trig, phase)
    _pe_lane_tables(num_freqs_d, 3, dx, sel, freq, idm, trig, phase)
    C = np.concatenate([sel, freq, idm, trig, phase], axis=0)
    return np.pad(C, ((0, PE_ROWS - C.shape[0]), (0, 0)))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def pe_only_plain(xd: torch.Tensor) -> torch.Tensor:
    """xd [P, 8] float32 -> the packed PE [P, 128]: xs = the lane's input
    channel times its frequency (a power of two, exact), pe = xs on the
    identity lanes and sin(xs + phase) on the trig lanes, 0 elsewhere."""
    C = torch.from_numpy(_pe_consts_np(NUM_FREQS_X, NUM_FREQS_D)).to(xd.device)
    sel, freq = C[:fused.XD_CH], C[fused.XD_CH]
    idm, trig, phase = (C[fused.XD_CH + i] for i in (1, 2, 3))
    xs = xd[:, sel.argmax(0)] * freq  # lanes without a channel have freq 0
    return idm * xs + trig * torch.sin(xs + phase)


def mm_only_plain(mlp, pe: torch.Tensor, compute_dtype: str = "bfloat16") -> torch.Tensor:
    """The scene MLP on a packed PE [P, 128] -> [P, 128]: lane 0 = rgb0 +
    alpha, lanes 1, 2 = rgb1, rgb2, zeros elsewhere (the TPU kernel's
    `concat(rgb[:, :4], 0) + alpha`).  The MLP is the forward kernel's plain
    version after its PE stage (`nerf_mlp.plain_mlp`)."""
    nx, nd = pe_out_dims(NUM_FREQS_X, NUM_FREQS_D)
    f = fused.plain_mlp(mlp, pe[:, :nx], pe[:, nx:nx + nd], compute_dtype)
    rgb, alpha = f["rgb"], f["alpha"]
    out = pe.new_zeros((pe.shape[0], LANES))
    out[:, 0] = rgb[:, 0] + alpha[:, 0]
    out[:, 1:3] = rgb[:, 1:3]
    return out


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("nerf_pe_mm")
    if not getattr(lib, "_lushnerf_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nerf_pe_only.argtypes = [vp, vp, ci, vp]
        lib.nerf_pe_only.restype = ci
        lib.nerf_mm_only.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.nerf_mm_only.restype = ci
        lib.nerf_pe_mm_w_numel.argtypes = [ci, ci]
        lib.nerf_pe_mm_w_numel.restype = ctypes.c_longlong
        lib.nerf_pe_mm_fp_numel.argtypes = []
        lib.nerf_pe_mm_fp_numel.restype = ctypes.c_longlong
        lib.nerf_pe_mm_error_string.argtypes = [ci]
        lib.nerf_pe_mm_error_string.restype = ctypes.c_char_p
        if lib.nerf_pe_mm_fp_numel() != fused.FP_NUMEL:
            raise RuntimeError("nerf_pe_mm: f32 blob layout differs from the CUDA source")
        lib._lushnerf_typed = True
    return lib


def _check(name: str, lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.nerf_pe_mm_error_string(rc).decode()})")


def pe_only(xd: torch.Tensor) -> torch.Tensor:
    """The packed PE [P, 128] of xd [P, 8] float32 (see `pe_only_plain`).
    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error."""
    if xd.device.type == "cpu":
        return pe_only_plain(xd)
    if xd.device.type != "cuda":
        raise ValueError(f"pe_only: unsupported device {xd.device}")
    if xd.dtype != torch.float32 or xd.dim() != 2 or xd.shape[1] != fused.XD_CH:
        raise ValueError(f"pe_only: xd must be float32 [P, {fused.XD_CH}], got "
                         f"{xd.dtype} {tuple(xd.shape)}")
    xd = xd.contiguous()
    P = xd.shape[0]
    out = torch.empty((P, LANES), dtype=torch.float32, device=xd.device)
    if P == 0:
        return out
    lib = _lib()
    fused._check_aligned("pe_only", xd, out)
    build.claim_device(xd.device.index)
    with torch.cuda.device(xd.device):
        rc = lib.nerf_pe_only(xd.data_ptr(), out.data_ptr(), P,
                              torch.cuda.current_stream(xd.device).cuda_stream)
    _check("pe_only", lib, rc)
    global launches_pe_only
    launches_pe_only += 1
    return out


@torch.no_grad()
def mm_only(mlp, pe: torch.Tensor) -> torch.Tensor:
    """The scene MLP in bfloat16 on a packed PE [P, 128] float32 -> [P, 128]
    (see `mm_only_plain`); no gradient.  CPU tensor: the plain version.
    CUDA tensor: the kernel, or an error."""
    if pe.device.type == "cpu":
        return mm_only_plain(mlp, pe, "bfloat16")
    if pe.device.type != "cuda":
        raise ValueError(f"mm_only: unsupported device {pe.device}")
    cfg = mlp.cfg
    # raises unless the MLP's inputs are the packed PE's layout
    fused.check_kernel_family(cfg, "bfloat16", NUM_FREQS_X, NUM_FREQS_D)
    if pe.dtype != torch.float32 or pe.dim() != 2 or pe.shape[1] != LANES:
        raise ValueError(f"mm_only: pe must be float32 [P, {LANES}], got "
                         f"{pe.dtype} {tuple(pe.shape)}")
    kx, kd = fused.pe_geometry(cfg)[:2]
    pe = pe.contiguous()
    w, fp = fused.pack_params(mlp, "bfloat16")
    if w.device != pe.device:
        raise ValueError(f"mm_only: params on {w.device}, pe on {pe.device}")
    P = pe.shape[0]
    out = torch.empty((P, LANES), dtype=torch.float32, device=pe.device)
    if P == 0:
        return out
    lib = _lib()
    if w.numel() != lib.nerf_pe_mm_w_numel(kx, kd):
        raise RuntimeError("mm_only: weight blob layout differs from the CUDA source")
    fused._check_aligned("mm_only", pe, w, fp, out)
    n_blocks = fused.fwd_grid(P, fused.sm_count(pe.device))
    build.claim_device(pe.device.index)
    with torch.cuda.device(pe.device):
        rc = lib.nerf_mm_only(pe.data_ptr(), w.data_ptr(), fp.data_ptr(), out.data_ptr(), P,
                              kx, kd, n_blocks, torch.cuda.current_stream(pe.device).cuda_stream)
    _check("mm_only", lib, rc)
    global launches_mm_only
    launches_mm_only += 1
    return out
