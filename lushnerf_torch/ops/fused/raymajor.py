"""Per-ray primitives of a ray-major fused renderer: the CUDA kernels'
wrappers (`lushnerf_torch/csrc/raymajor_probe.cu`), their plain PyTorch
versions and launch counters.

Per-sample values are laid out ray by ray, as the JAX probe lays them out:
row t * S + s of a [T*S, c] array is sample s of ray t.

  excl_cumsum(x, S)          x [T*S, c] -> [T*S, c], the exclusive cumsum over
                             each ray's samples (the TPU probes P1 and P1b)
  ray_transpose(x, S)        [T*S, 1] -> [T, S] (probe P2)
  searchsorted_count(cdf, u) cdf [T, S], u [T*SI, 1] -> [T*SI, 1] float, the
                             count of cdf[t, :] <= u (probe P3)
  masked_dists(z, S)         z [T*S, 1] -> z[k+1] - z[k], 0 at each ray's
                             last sample (probe P4)

They replace the Pallas TPU kernels of `scripts/probe_raymajor_mosaic.py`.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  The counters `launches_excl_cumsum`,
`launches_transpose`, `launches_searchsorted` and `launches_masked_dists`
are plain integers (set them to 0 to start counting; each wrapper adds one
where it launches, and nowhere else).
"""

from __future__ import annotations

import ctypes

import torch

from lushnerf_torch.ops.fused import build

# cdf row length the searchsorted kernel stages: 8 rows (one a warp, padded
# to 4 floats) in 48 KB of shared memory
SMEM_ROW_MAX = 48 * 1024 // 4 // 8

# The vector cumsum (the kernel for c a power of two up to 128): a thread
# takes a float4, a block 8 warps; a group (a warp, or the block: one of
# CS_GROUPS warps) takes whole rays, 128 floats a warp a pass.
CS_GROUPS = (1, 8)
VEC_CHANNELS = (1, 2, 4, 8, 16, 32, 64, 128)
# The largest element count the kernels' 32-bit index arithmetic takes: a
# block's last pass may index up to 1024 floats past the end.
INDEX32_MAX = 2**31 - 1 - 2048

# Kernel launches since they were last set to 0.
launches_excl_cumsum = 0
launches_transpose = 0
launches_searchsorted = 0
launches_masked_dists = 0


def _rays(x: torch.Tensor, S: int) -> int:
    if S <= 0 or x.dim() != 2 or x.shape[0] % S:
        raise ValueError(f"expected [T*S, c] rows for S = {S}, got {tuple(x.shape)}")
    return x.shape[0] // S


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def excl_cumsum_plain(x: torch.Tensor, S: int) -> torch.Tensor:
    T = _rays(x, S)
    cs = torch.cumsum(x.reshape(T, S, -1), dim=1)
    return torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], dim=1).reshape(x.shape)


def ray_transpose_plain(x: torch.Tensor, S: int) -> torch.Tensor:
    return x.reshape(_rays(x, S), S).clone()


def searchsorted_count_plain(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    T = cdf.shape[0]
    return (cdf[:, None, :] <= u.reshape(T, -1, 1)).sum(-1).to(torch.float32).reshape(-1, 1)


def masked_dists_plain(z: torch.Tensor, S: int) -> torch.Tensor:
    zz = z.reshape(_rays(z, S), S)
    return torch.cat([zz[:, 1:] - zz[:, :-1], torch.zeros_like(zz[:, :1])], dim=1).reshape(z.shape)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def cumsum_plan(S: int, c: int) -> tuple:
    """(warps a group, rays a group) of the vector cumsum: each warp alone
    where its pass of 128 floats holds a whole ray (no barrier), else the
    block of 8 warps; (0, 0) for a c the vector kernel does not take (the
    general kernel: one warp per ray)."""
    if c not in VEC_CHANNELS:
        return 0, 0
    L = S * c
    group = 1 if L + (3 if L % 4 else 0) <= 128 else 8
    return group, cumsum_rays_per_block(S, c, group)


def cumsum_rays_per_block(S: int, c: int, group: int) -> int:
    """Rays a group of `group` warps takes: as many as fit in one pass of
    128 * group floats (the first float4 may hold up to 3 floats of the ray
    before, when S * c is not a multiple of 4), at least 1 (a longer ray
    takes several passes)."""
    L = S * c
    return max(1, (128 * group - (3 if L % 4 else 0)) // L)


def divider(d: int) -> tuple:
    """(m, s) with x // d == (x * m) >> s for every 0 <= x < 2**31, m < 2**32:
    m = floor(2**s / d) + 1, s = 31 + ceil(log2 d) (then m * d - 2**s lies
    in (0, d], within 2**(s - 31))."""
    s = 31 + (d - 1).bit_length()
    return (1 << s) // d + 1, s


def index64(n: int) -> bool:
    """Whether n elements need the kernels' 64-bit index arithmetic."""
    return n > INDEX32_MAX


def _lib() -> ctypes.CDLL:
    lib = build.load("raymajor_probe")
    if not getattr(lib, "_lushnerf_typed", False):
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        cu = ctypes.c_uint
        lib.raymajor_excl_cumsum.argtypes = [vp, vp, ci, ci, ci, ci, ci, cu, ci, ci, vp]
        lib.raymajor_transpose.argtypes = [vp, vp, cl, vp]
        lib.raymajor_searchsorted.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.raymajor_masked_dists.argtypes = [vp, vp, cl, ci, cu, ci, ci, vp]
        for fn in (lib.raymajor_excl_cumsum, lib.raymajor_transpose,
                   lib.raymajor_searchsorted, lib.raymajor_masked_dists):
            fn.restype = ci
        lib.raymajor_error_string.argtypes = [ci]
        lib.raymajor_error_string.restype = ctypes.c_char_p
        lib._lushnerf_typed = True
    return lib


def _inputs(name: str, *tensors: torch.Tensor):
    """The CUDA inputs, contiguous; raises on another device or dtype."""
    out = []
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors must be on one CUDA device, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 only, got {t.dtype}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        out.append(t)
    return out


def _launch(name: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({_lib().raymajor_error_string(rc).decode()})")


def excl_cumsum(x: torch.Tensor, S: int, wide: bool | None = None) -> torch.Tensor:
    """[T*S, c] -> the exclusive cumsum over each ray's S samples.  `wide`
    takes the 64-bit index arithmetic (default: where the size needs it)."""
    if x.device.type == "cpu":
        return excl_cumsum_plain(x, S)
    T = _rays(x, S)
    (x,) = _inputs("excl_cumsum", x)
    y = torch.empty_like(x)
    if x.numel():
        c = x.shape[1]
        wide = index64(x.numel()) if wide is None else wide
        _launch("excl_cumsum", _lib().raymajor_excl_cumsum, x.data_ptr(), y.data_ptr(), T, S,
                c, *cumsum_plan(S, c), *((0, 0) if wide else divider(S * c)), int(wide),
                device=x.device)
        global launches_excl_cumsum
        launches_excl_cumsum += 1
    return y


def ray_transpose(x: torch.Tensor, S: int) -> torch.Tensor:
    """Per-ray vector [T*S, 1] -> [T, S]."""
    if x.device.type == "cpu":
        return ray_transpose_plain(x, S)
    T = _rays(x, S)
    if x.shape[1] != 1:
        raise ValueError(f"ray_transpose: expected [T*S, 1], got {tuple(x.shape)}")
    (x,) = _inputs("ray_transpose", x)
    y = torch.empty((T, S), dtype=torch.float32, device=x.device)
    if x.numel():
        _launch("ray_transpose", _lib().raymajor_transpose, x.data_ptr(), y.data_ptr(),
                x.numel(), device=x.device)
        global launches_transpose
        launches_transpose += 1
    return y


def searchsorted_count(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cdf [T, S], u [T*SI, 1] -> [T*SI, 1] float32: the count of cdf[t, :]
    <= u for each of ray t's SI values (for a sorted row, torch.searchsorted
    with right=True)."""
    if cdf.device.type == "cpu" and u.device.type == "cpu":
        return searchsorted_count_plain(cdf, u)
    if cdf.dim() != 2 or u.dim() != 2 or u.shape[1] != 1 or u.shape[0] % max(cdf.shape[0], 1):
        raise ValueError(f"searchsorted_count: cdf [T, S] and u [T*SI, 1], got "
                         f"{tuple(cdf.shape)} and {tuple(u.shape)}")
    T, S = cdf.shape
    if S > SMEM_ROW_MAX:
        raise ValueError(f"searchsorted_count: S = {S} exceeds the kernel's {SMEM_ROW_MAX}")
    cdf, u = _inputs("searchsorted_count", cdf, u)
    out = torch.empty_like(u)
    if u.numel() and S:
        _launch("searchsorted_count", _lib().raymajor_searchsorted, cdf.data_ptr(), u.data_ptr(),
                out.data_ptr(), T, S, u.shape[0] // T, device=u.device)
        global launches_searchsorted
        launches_searchsorted += 1
    else:
        out.zero_()
    return out


def masked_dists(z: torch.Tensor, S: int, wide: bool | None = None) -> torch.Tensor:
    """z [T*S, 1] -> z[k+1] - z[k] within each ray, 0 at its last sample.
    `wide` as for excl_cumsum."""
    if z.device.type == "cpu":
        return masked_dists_plain(z, S)
    _rays(z, S)
    if z.shape[1] != 1:
        raise ValueError(f"masked_dists: expected [T*S, 1], got {tuple(z.shape)}")
    (z,) = _inputs("masked_dists", z)
    d = torch.empty_like(z)
    if z.numel():
        wide = index64(z.numel()) if wide is None else wide
        _launch("masked_dists", _lib().raymajor_masked_dists, z.data_ptr(), d.data_ptr(),
                z.numel(), S, *((0, 0) if wide else divider(S)), int(wide), device=z.device)
        global launches_masked_dists
        launches_masked_dists += 1
    return d
