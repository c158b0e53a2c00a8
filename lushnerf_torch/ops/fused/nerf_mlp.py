"""Fused NeRF-MLP: the CUDA kernels' wrappers, their plain PyTorch versions,
the autograd Function that joins them, and launch counters.

The forward kernel (`lushnerf_torch/csrc/nerf_mlp_fwd.cu`) computes, per
point, positional encoding + the 8xW scene MLP (skip at layer 4) + alpha /
feature / views / rgb heads, and writes raw [rgb, alpha]; for training it
also writes the activation stash a0..a7, feat, hv.  It replaces the Pallas
TPU kernel `_fwd_kernel` of `lushnerf_tpu/ops/fused/nerf_mlp.py`.  Both
modes run `csrc/nerf_mlp_fwd_sm90.cuh` (wgmma, a persistent grid that
streams the weights through a ring of bulk copies); `fwd_grid` and
`fwd_tiles` are its geometry.  Every kernel source is built for the MLP's
width (`build.load(source, width)`): 256 and 128, in both compute dtypes
(`KERNEL_WIDTHS`).  The kernels' views layer has VIEWS_LANES = 128
lanes at both (W / 2 at 256; at 128 its 64 columns padded with zero
weights, as the JAX package's `pad_params` pads them), so the stash, the
blobs and the grads' layouts are functions of the width (`layout`).  The
backward kernels compute d(xd) and the grads of every parameter from the
stash (replacing `_bwd_stash_kernel`, mode 'stash') or, in mode 'remat'
(replacing `_bwd_kernel`), from a stash the forward kernel writes into
scratch first: a dgrad kernel (`csrc/nerf_mlp_dgrad.cu`, wgmma; in f32
the split with a power-of-two scale per point), then the wgrad on wgmma
over the work items of `wgrad_items` (bf16: TMA-loaded bf16 stages; f32:
the split with a power-of-two scale per point split and d_z block, from
the scale units the dgrad writes: `dz_scale_units`, and one per split and
stash block for the activations, from those K1 f32 writes beside its
stash: `stash_scale_units`) and two fixed-order reductions
(`csrc/nerf_mlp_bwd.cu`).  The backward's scratch covers one point chunk
at a time (`point_chunks`, render_cfg.point_chunk).

`NerfMLPFn` is the gradient: on a CPU tensor it runs `nerf_mlp_fwd_plain`
and `nerf_mlp_bwd_plain`; on a CUDA tensor it launches the kernels or
raises.  `nerf_mlp_fwd` is the output-only wrapper (render, no_grad).

Launch counters (plain integers, set them to 0 to start counting; each
wrapper adds to its own where it launches, and nowhere else):
`launches` counts forward kernel launches (with or without the stash),
`launches_bwd_stash` / `launches_bwd_remat` the backward's kernel launches
(four per point chunk: dgrad, wgrad and two fixed-order reductions; remat
adds the forward kernel that writes the chunk's stash), `launches_pack`
the weight packs' (below), which `launches` and the backward's counters
leave out.  A parameter packing (cached per parameter version) records an
`mlp.pack` span (`lushnerf_torch.utils.trace`).

The weight packs (`pack_params`, `pack_params_bwd`): on the CPU torch ops,
the plain version, whose f32 range checks read the device (`sync.pack_range`
spans) and raise at once.  On the card each pack is one launch of
`csrc/nerf_mlp_pack.cu`, which gathers the blobs from the parameters in
place by maps that the torch ops' layout code makes once per geometry
(`pack_maps`; its plain version `pack_gather`), bit for bit the torch
blobs.  Its f32 range flag comes to the host behind an event and is read
at the module's next call of the same pack, which raises the same
ValueError; it waits, in a `sync.pack_range` span, only if the device has
not passed the event.

The grads come in the order of `mlp.parameters()` of a `NeRFMLP`: (weight,
bias) of pts_linears 0..7, feature, alpha, views, rgb -- 24 tensors.  The
TPU kernel's 26 padded arrays are these with W5 and the views weight each
split in two by input.

compute_dtype:
  'float32'  -- f32-grade products and f32 sums: the plain versions in IEEE
                f32 (no TF32); the forward kernel splits each operand in two
                fp16 parts (`split_f16`; the weights' of w 2^SPLIT_SHIFT, an
                activation row's of its values 2^-k, `row_scale_exponents`,
                so that no part overflows) and takes each product as three
                fp16 products of the parts into an f32 accumulator, as the
                TPU kernel's f32 mode runs the MXU at Precision.HIGHEST.
  'bfloat16' -- every matmul input (PE, activations, weights, and in the
                backward the cotangents) rounded to bf16, f32 accumulation,
                f32 bias and relu: the rounding points of the TPU kernel's
                bfloat16 mode.
"""

from __future__ import annotations

import copy
import ctypes
import math
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from lushnerf_torch.ops.encoding import posenc, posenc_backward
from lushnerf_torch.ops.fused import build
from lushnerf_torch.utils.trace import span

WIDTH = 256  # the flagship's width, whose layout the constants below give
# the widths each compute dtype's kernels are built for
KERNEL_WIDTHS = {"float32": (256, 128), "bfloat16": (256, 128)}
VIEWS_LANES = 128  # the kernels' views layer: W / 2 at 256, zero-padded at 128
# The PE domain: the JAX kernels pack pe_x and pe_d tightly into one
# 128-lane register (in_ch + d_ch <= PE_LANES); the port's backward pads each
# to 32 channels (kx + kd <= PE_PAD_MAX), its forward's PE tile holds
# PE_LANES columns (`pe_geometry`)
PE_LANES = 128
PE_PAD_MAX = 160
XD_CH = 8  # packed input lanes: 0:3 xyz, 3:6 viewdir, 6:8 zero
OUT_CH = 4  # output lanes: 0:3 rgb, 3 alpha


class Layout(NamedTuple):
    """The kernels' layouts at one width (mirrors nerf_mlp_common.cuh): the
    stash row (a0..a7, feat, hv) and the offsets into the f32 blob."""
    width: int
    acts_ld: int
    fp_bf: int
    fp_bv: int
    fp_ba: int
    fp_br: int
    fp_wa: int
    fp_wr: int
    fp_numel: int


def layout(width: int) -> Layout:
    bf = 8 * width
    bv = bf + width
    ba = bv + VIEWS_LANES
    br = ba + 4
    wa = br + 4
    wr = wa + width
    return Layout(width, 9 * width + VIEWS_LANES, bf, bv, ba, br, wa, wr, wr + 3 * VIEWS_LANES)


def width_of_ld(ld: int) -> int:
    """The width whose stash (and dz) rows are `ld` long."""
    return (ld - VIEWS_LANES) // 9


_L256 = layout(WIDTH)
ACTS_LD = _L256.acts_ld  # stash row: a0..a7, feat, hv
# offsets into the f32 blob (mirrors FP_* in the CUDA source)
FP_BF, FP_BV, FP_BA, FP_BR, FP_WA, FP_WR, FP_NUMEL = _L256[2:]

# The dgrad kernel's stages, in order (its stage stamps mark the end of
# each; mirrors the stamps in csrc/nerf_mlp_dgrad.cu): bf16, and f32, which
# runs the W5a pass of d_pe_x right after d_z5's epilogue (in f32 "wait" is
# the mask bits' wait, "load" is empty)
DGRAD_STAGES = (
    ["load", "heads", "dpe_wvd", "dxd_views"]
    + [f"{k}_{z}" for z in ["feat"] + [f"z{l}" for l in range(7, -1, -1)]
       for k in ("mm", "wait", "ep")]
    + ["dpe_x", "dxd_x"]
)
_EP_Z5 = DGRAD_STAGES.index("ep_z5") + 1
DGRAD_STAGES_F32 = DGRAD_STAGES[:_EP_Z5] + ["dpe_w5a"] + DGRAD_STAGES[_EP_Z5:]
# then, off the consumers' path, the f32 dgrad's PE thread 0's cycles a
# tile by task (mirrors PW_* in csrc/nerf_mlp_dgrad.cu)
DGRAD_OFF_PATH_F32 = ("pe_free_wait", "pe_ready_wait", "pe_masks", "pe_dz", "pe_encode")
DGRAD_TILE = 128  # points a tile of the dgrad kernel, both modes
# The f32 dgrad's scale units of dz for the f32 wgrad (`dz_scale_units`):
# [tiles, ZS_BLOCKS, ZS_WARPS], the blocks d_z0..d_z7, d_feat, d_hv and the
# dgrad's three PE warps (warp w stores the rows p % 3 == w of a tile)
ZS_BLOCKS, ZS_WARPS = 10, 3
# K1 f32's scale units of its f32 stash for the f32 wgrad
# (`stash_scale_units`): [tiles, UNIT_BLOCKS, UNIT_WARPS], the blocks a0..a7
# and feat, and the forward's eight consumer warps (warp w holds the rows
# 16 w .. 16 w + 15 of a tile)
UNIT_BLOCKS, UNIT_WARPS = 9, 8
# The f32 wgrad's point splits (a partial of the weight grads each): at most
# one per SM of an H100 (132), at least WGRAD_F32_SPLIT_POINTS points each
WGRAD_F32_SPLITS, WGRAD_F32_SPLIT_POINTS = 132, 2048
# In a backward of several point chunks the f32 wgrad's splits of a chunk
# take at least WGRAD_F32_CHUNK_SPLIT_POINTS points each, as many as fill
# whole waves of its grid (`chunk_wgrad_splits`)
WGRAD_F32_CHUNK_SPLIT_POINTS = 4096


def wgrad_tiles(width: int = WIDTH) -> int:
    """The wgrads' output tiles a split (mirrors N_TILES in
    csrc/nerf_mlp_bwd.cu): 128 rows of each of the 12 weight blocks."""
    return 10 * (width // 128) + 2


WGRAD_TILES = wgrad_tiles()
# The bf16 wgrad's: at most WGRAD_BF16_SPLITS (its 22 x 12 units fall 4 a
# cluster on the 132 SMs: 3 wide, 1 narrow), at least WGRAD_BF16_SPLIT_POINTS
# points each.  Its partials' bytes cost more than spreading its units
# evenly (scripts/wgrad_splits.py times 11 to 132 splits; PERF.md)
WGRAD_BF16_SPLITS, WGRAD_BF16_SPLIT_POINTS = 22, 4096
# points a stage of each wgrad (every split but the last is a whole number
# of stages; mirrors KS in csrc/nerf_mlp_bwd.cu)
WGRAD_STAGE = {"float32": 32, "bfloat16": 64}
WGRAD_TILE_ROWS = 128  # rows o of a wgrad work item's output tile
# its instrumented instantiation's cycle counts, block 0: consumer thread 0
# (waiting for a full stage, issuing and waiting for the matmuls, storing
# partials, all), then converter thread 0 (issuing a stage's loads, waiting
# for a free stage, the items' scales, splitting and storing a stage with
# the wait for its loads, all); mirrors N_CLK in csrc/nerf_mlp_bwd.cu
WGRAD_F32_CLOCKS = ("mm_full_wait", "mm", "mm_epilogue", "mm_all", "conv_load_issue",
                    "conv_empty_wait", "conv_scale", "conv_work", "conv_all")
# the bf16 wgrad's: consumer thread 0 as above, then the producer thread
# (waiting for a free stage, all)
WGRAD_BF16_CLOCKS = ("mm_full_wait", "mm", "mm_epilogue", "mm_all", "load_empty_wait", "load_all")

# The forward kernel's stages: consumer thread 0's cycles of each in each
# tile of block 0 (its instrumented instantiation), then, off that path, the
# PE warps' work (mirrors ST_* in csrc/nerf_mlp_fwd_sm90.cuh)
FWD_STAGES = ("pe_wait", "weight_wait", "mm", "stash_wait", "epilogue", "stash", "out")
FWD_OFF_PATH = ("pe_work",)
FWD_TILE = 128  # points a tile of the forward kernel
FWD_PIECE = 128 * 64  # elements of a weight piece of either weight blob
SPLIT_RING = 4  # the f32 blob's pieces a tile: a multiple of the split's ring stages
# the f32 kernel's fp16 parts of the weights are those of w 2^SPLIT_SHIFT
# (mirrors SPLIT_SHIFT in csrc/nerf_mlp_fwd_sm90.cuh); an activation row's
# are those of its values times 2^-k, k the least k >= 0 that puts the
# row's largest |value| below 2^ROW_SCALE_BITS (`row_scale_exponents`)
SPLIT_SHIFT = 4
ROW_SCALE_BITS = 15
FP16_MAX = 65504.0

COMPUTE_DTYPES = ("float32", "bfloat16")
BWD_MODES = ("remat", "stash")
# the csrc/ sources of the forward, the backward's wgrad and reductions, and
# the dgrads (`build.load` names); the dgrads' build for a PE with a part of
# 128 channels (kx or kd: their d_pe passes take 64 accumulators a thread)
SOURCES = ("nerf_mlp_fwd", "nerf_mlp_bwd", "nerf_mlp_dgrad")
WIDE_PE_SOURCE = "nerf_mlp_dgrad_wide"
# the weight packs' source (one build for every width and dtype), and its
# codes: parameter a >> PACK_OFF_BITS, at most PACK_MAX_PARAMS of them, at
# offset a & (2^PACK_OFF_BITS - 1) (mirrors csrc/nerf_mlp_pack.cu; `pack_maps`)
PACK_SOURCE = "nerf_mlp_pack"
PACK_MAX_PARAMS, PACK_OFF_BITS = 32, 17

# Kernel launches since they were last set to 0.
launches = 0
launches_bwd_stash = 0
launches_bwd_remat = 0
launches_pack = 0


def _round32(n: int) -> int:
    return -(-n // 32) * 32


class PEGeometry(NamedTuple):
    """Where the kernels keep an MLP's PE.  The backward's PE scratch is
    [P, kx + kd]: pe_x and pe_d each padded to 32 channels.  The forward's
    PE tile is [P][PE_LANES]: pe_x at columns [0, in_ch), pe_d at [dx, dx +
    d_ch), zeros elsewhere, in chunks of 64 columns; W0 and W5's pe_x part
    read its first nx chunks, Wv's pe_d part its nd chunks from chunk d0."""
    kx: int
    kd: int
    dx: int
    nx: int
    d0: int
    nd: int


def pe_geometry(mlp_cfg) -> PEGeometry:
    """The one place that decides the PE geometry of an MLP (`PEGeometry`):
    dx = kx (each part padded to 32 channels) where kx + kd <= PE_LANES, so
    that those PEs keep their blobs and their bits, else dx = in_ch (the
    JAX kernels' tight packing, which keeps every PE with in_ch + d_ch <=
    PE_LANES in the tile)."""
    in_ch, d_ch = mlp_cfg.input_ch, mlp_cfg.input_ch_views
    kx, kd = _round32(in_ch), _round32(d_ch)
    dx = kx if kx + kd <= PE_LANES else in_ch
    d0 = dx // 64
    return PEGeometry(kx, kd, dx, -(-in_ch // 64), d0, -(-(dx + d_ch) // 64) - d0)


def fwd_grid(P: int, n_sm: int) -> int:
    """Blocks of the forward kernel's persistent grid for P > 0 points:
    one a tile, at most one an SM (its shared memory fills one)."""
    return max(1, min(n_sm, -(-P // FWD_TILE)))


def fwd_tiles(P: int, n_blocks: int) -> List[List[int]]:
    """The tiles each block of that grid computes, in its loop's order:
    block b takes tiles b, b + n_blocks, ..."""
    return [list(range(b, -(-P // FWD_TILE), n_blocks)) for b in range(n_blocks)]


def supports(mlp_cfg, render_cfg) -> bool:
    """The fused MLP family, the same as the JAX package's: depth 8, width a
    multiple of 128, skip at layer 4, viewdirs on, both PEs within 128
    channels together.  The 'cuda' backend sends a member to the fused path
    only where `kernel_covers` holds too."""
    return (
        mlp_cfg.depth == 8
        and mlp_cfg.width % 128 == 0
        and mlp_cfg.width >= 128
        and tuple(mlp_cfg.skips) == (4,)
        and mlp_cfg.use_viewdirs
        and not mlp_cfg.rgb_only
        and mlp_cfg.input_ch + mlp_cfg.input_ch_views <= PE_LANES
    )


def kernel_gap(mlp_cfg, compute_dtype: str, num_freqs_x: int, num_freqs_d: int) -> Optional[str]:
    """Why the compiled kernels do not cover this MLP, PE and compute dtype
    (a width of KERNEL_WIDTHS[compute_dtype]; PEs of num_freqs_x /
    num_freqs_d frequencies with in_ch + d_ch <= PE_LANES, every one the
    JAX kernels take, in both dtypes), or None where they do."""
    if compute_dtype not in COMPUTE_DTYPES:
        return f"compute_dtype {compute_dtype!r} not in {COMPUTE_DTYPES}"
    if not (mlp_cfg.depth == 8 and tuple(mlp_cfg.skips) == (4,) and mlp_cfg.use_viewdirs
            and not mlp_cfg.rgb_only):
        return "the kernel covers depth 8, skip at 4, viewdirs on"
    widths = KERNEL_WIDTHS[compute_dtype]
    if mlp_cfg.width not in widths:
        return (f"the {compute_dtype} kernels are compiled for width "
                f"{' and '.join(map(str, widths))}, not {mlp_cfg.width}")
    if 3 + 6 * num_freqs_x != mlp_cfg.input_ch or 3 + 6 * num_freqs_d != mlp_cfg.input_ch_views:
        return (f"PE of {num_freqs_x}/{num_freqs_d} frequencies does not give the MLP's "
                f"{mlp_cfg.input_ch}/{mlp_cfg.input_ch_views} inputs")
    if mlp_cfg.input_ch + mlp_cfg.input_ch_views > PE_LANES:
        return (f"PE of {mlp_cfg.input_ch} + {mlp_cfg.input_ch_views} channels is past the "
                f"kernels' {PE_LANES} PE lanes")
    return None


def kernel_covers(mlp_cfg, render_cfg) -> bool:
    """Whether the compiled kernels cover this MLP at the render config's PE
    and compute dtype.  Decided by shape alone, before any launch: the
    renderer sends an MLP to the fused path only where `supports` and this
    hold, and any other (a width of 384 or 512) takes the plain torch path
    on the same device, as the JAX renderer does for MLPs outside its
    family."""
    return kernel_gap(mlp_cfg, render_cfg.mlp_compute_dtype, render_cfg.multires,
                      render_cfg.multires_views) is None


def kernel_builds(mlp_cfgs, render_cfg) -> List[Tuple[str, Optional[int]]]:
    """The (source, width) builds the fused path launches for these MLPs
    under the render config (those `supports` and `kernel_covers` send to
    it), for `build.build_all`; the weight packs' source takes no width."""
    fused = [c for c in mlp_cfgs if supports(c, render_cfg) and kernel_covers(c, render_cfg)]
    widths = sorted({c.width for c in fused})
    wide = sorted({c.width for c in fused if 128 in pe_geometry(c)[:2]})
    return ([(PACK_SOURCE, None)] if fused else []) + [
        (src, w) for w in widths for src in SOURCES] + [(WIDE_PE_SOURCE, w) for w in wide]


def check_kernel_family(mlp_cfg, compute_dtype: str, num_freqs_x: int,
                        num_freqs_d: int) -> None:
    """Raises ValueError unless the compiled kernel covers this MLP, PE and
    compute dtype (`kernel_gap`): a direct kernel call never falls back."""
    gap = kernel_gap(mlp_cfg, compute_dtype, num_freqs_x, num_freqs_d)
    if gap is not None:
        raise ValueError(f"nerf_mlp_fwd: {gap}")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _rounder(compute_dtype: str):
    if compute_dtype == "bfloat16":
        return lambda t: t.bfloat16().float()
    return lambda t: t


def _plain_forward(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d):
    """All of the plain forward's values: x_pe, d_pe, acts (a0..a7), feat,
    hv and the raw output."""
    x_pe = posenc(xd[:, 0:3], num_freqs_x)
    d_pe = posenc(xd[:, 3:6], num_freqs_d)
    return dict(x_pe=x_pe, d_pe=d_pe, **plain_mlp(mlp, x_pe, d_pe, compute_dtype))


def plain_mlp(mlp, x_pe, d_pe, compute_dtype):
    """The scene MLP on encoded inputs x_pe [P, input_ch], d_pe [P,
    input_ch_views], rounding where the kernels round: acts (a0..a7), feat,
    hv, rgb, alpha and the raw output [rgb, alpha].  The plain version of
    the forward kernel after its PE stage, and of the matmul-only kernel."""
    r = _rounder(compute_dtype)

    def dot(a, w):
        return r(a) @ r(w).T

    in_ch = mlp.cfg.input_ch
    W = mlp.cfg.width
    pts = mlp.pts_linears
    acts = []
    h = x_pe
    for i in range(5):
        h = torch.relu(dot(h, pts[i].weight) + pts[i].bias)
        acts.append(h)
    w5 = pts[5].weight
    h = torch.relu(dot(x_pe, w5[:, :in_ch]) + dot(h, w5[:, in_ch:]) + pts[5].bias)
    acts.append(h)
    for i in (6, 7):
        h = torch.relu(dot(h, pts[i].weight) + pts[i].bias)
        acts.append(h)
    alpha = dot(h, mlp.alpha_linear.weight) + mlp.alpha_linear.bias
    feat = dot(h, mlp.feature_linear.weight) + mlp.feature_linear.bias
    wv = mlp.views_linears[0].weight
    hv = torch.relu(dot(feat, wv[:, :W]) + dot(d_pe, wv[:, W:]) + mlp.views_linears[0].bias)
    rgb = dot(hv, mlp.rgb_linear.weight) + mlp.rgb_linear.bias
    return dict(acts=acts, feat=feat, hv=hv, rgb=rgb, alpha=alpha,
                out=torch.cat([rgb, alpha], dim=-1))


def stash_dtype(compute_dtype: str) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def nerf_mlp_fwd_plain(mlp, xd: torch.Tensor, compute_dtype: str = "float32",
                       num_freqs_x: int = 10, num_freqs_d: int = 4, with_acts: bool = False):
    """The kernel's function in PyTorch ops, rounding where it rounds.

    mlp: a `NeRFMLP` of the supported family; xd: [P, 8] float32.
    Returns raw [P, 4] = [rgb, alpha]; with `with_acts`, also the stash
    [P, 9 W + VIEWS_LANES] (a0..a7, feat, hv; hv's W / 2 columns padded
    with zeros to VIEWS_LANES, as the kernels' views layer) in the compute
    dtype, as the kernel writes it.  On CUDA set
    torch.backends.cuda.matmul.allow_tf32 = False, or the f32 products lose
    precision.
    """
    f = _plain_forward(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d)
    if not with_acts:
        return f["out"]
    hv = F.pad(f["hv"], (0, VIEWS_LANES - f["hv"].shape[1]))
    acts = torch.cat(f["acts"] + [f["feat"], hv], dim=1).to(stash_dtype(compute_dtype))
    return f["out"], acts


def nerf_mlp_bwd_plain(mlp, xd: torch.Tensor, g: torch.Tensor, compute_dtype: str = "float32",
                       num_freqs_x: int = 10, num_freqs_d: int = 4,
                       acts: Optional[torch.Tensor] = None):
    """The backward kernels' function in PyTorch ops: `_bwd_math` of the TPU
    kernel step by step, with its rounding points.

    g: [P, 4] cotangent of the raw output.  acts: the forward's stash
    (stash mode), or None to recompute the activations (remat mode); both
    give the same values.  Returns (d_xd [P, 8], the grads of
    `mlp.parameters()` in their shapes).  Every matmul input is rounded to
    the compute dtype (cotangents included); bias grads sum the unrounded
    f32 cotangents; relu masks test the stored activation.
    """
    r = _rounder(compute_dtype)

    def dot(a, b):  # a @ b
        return r(a) @ r(b)

    def dot_t(a, b):  # a^T @ b
        return r(a).T @ r(b)

    def mask(a):
        return (a > 0).float()

    cfg = mlp.cfg
    in_ch, W = cfg.input_ch, cfg.width
    x_pe = posenc(xd[:, 0:3], num_freqs_x)
    d_pe = posenc(xd[:, 3:6], num_freqs_d)
    if acts is None:
        f = _plain_forward(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d)
        a, feat, hv = f["acts"], f["feat"], f["hv"]
    else:
        s = acts.to(torch.promote_types(acts.dtype, torch.float32))  # f32, or f64 for f64 stash
        a = [s[:, l * W:(l + 1) * W] for l in range(8)]
        feat, hv = s[:, 8 * W:9 * W], s[:, 9 * W:9 * W + W // 2]
    pts = [lin.weight for lin in mlp.pts_linears]
    wf = mlp.feature_linear.weight
    wa = mlp.alpha_linear.weight
    wv = mlp.views_linears[0].weight
    wr = mlp.rgb_linear.weight
    g_rgb, g_a = g[:, :3], g[:, 3:4]

    d_hv = dot(g_rgb, wr) * mask(hv)
    d_feat = dot(d_hv, wv[:, :W])
    d_z = [None] * 8
    d_z[7] = (dot(d_feat, wf) + dot(g_a, wa)) * mask(a[7])
    d_z[6] = dot(d_z[7], pts[7]) * mask(a[6])
    d_z[5] = dot(d_z[6], pts[6]) * mask(a[5])
    d_z[4] = dot(d_z[5], pts[5][:, in_ch:]) * mask(a[4])
    for l in (3, 2, 1, 0):
        d_z[l] = dot(d_z[l + 1], pts[l + 1]) * mask(a[l])
    d_pe_x = dot(d_z[0], pts[0]) + dot(d_z[5], pts[5][:, :in_ch])
    d_pe_d = dot(d_hv, wv[:, W:])

    g_w = [dot_t(d_z[0], x_pe)] + [dot_t(d_z[l], a[l - 1]) for l in range(1, 5)]
    g_w.append(torch.cat([dot_t(d_z[5], x_pe), dot_t(d_z[5], a[4])], dim=1))
    g_w += [dot_t(d_z[6], a[5]), dot_t(d_z[7], a[6])]
    grads = []
    for l in range(8):
        grads += [g_w[l], d_z[l].sum(0)]
    grads += [dot_t(d_feat, a[7]), d_feat.sum(0)]
    grads += [dot_t(g_a, a[7]), g_a.sum(0)]
    grads += [torch.cat([dot_t(d_hv, feat), dot_t(d_hv, d_pe)], dim=1), d_hv.sum(0)]
    grads += [dot_t(g_rgb, hv), g_rgb.sum(0)]
    d_xd = torch.cat([posenc_backward(xd[:, 0:3], d_pe_x, num_freqs_x),
                      posenc_backward(xd[:, 3:6], d_pe_d, num_freqs_d),
                      xd.new_zeros(xd.shape[0], XD_CH - 6)], dim=1)
    return d_xd, grads


def wgrad_splits(P: int, compute_dtype: str) -> int:
    """The wgrad's point splits for P > 0 points (a partial of the weight
    grads each).  f32: one per WGRAD_F32_SPLIT_POINTS, at most
    WGRAD_F32_SPLITS.  bf16: one per WGRAD_BF16_SPLIT_POINTS, at most
    WGRAD_BF16_SPLITS, then as many as the splits of whole stages need
    (`bf16_splits_of`)."""
    if compute_dtype != "bfloat16":
        return max(1, min(WGRAD_F32_SPLITS, -(-P // WGRAD_F32_SPLIT_POINTS)))
    return bf16_splits_of(P, max(1, min(WGRAD_BF16_SPLITS, -(-P // WGRAD_BF16_SPLIT_POINTS))))


def chunk_wgrad_splits(n: int, compute_dtype: str, n_chunks: int, n_sm: int,
                       width: int = WIDTH) -> int:
    """The wgrad's point splits for a chunk of n points of a backward in
    n_chunks chunks on n_sm SMs: `wgrad_splits(n)` in one chunk (an
    unchunked backward's bits) and in bf16; in f32 over several chunks the
    most splits of at least WGRAD_F32_CHUNK_SPLIT_POINTS points whose work
    items (`wgrad_tiles(width)` a split, one block an SM) fill whole
    waves, where any do, so that a chunk's items end together and its
    partials are few (else `wgrad_splits(n)`)."""
    if n_chunks == 1 or compute_dtype == "bfloat16":
        return wgrad_splits(n, compute_dtype)
    q = n_sm // math.gcd(wgrad_tiles(width), n_sm)
    splits = q * (n // (q * WGRAD_F32_CHUNK_SPLIT_POINTS))
    return splits if splits > 0 else wgrad_splits(n, compute_dtype)


def bf16_splits_of(P: int, n: int) -> int:
    """The bf16 wgrad's splits when P points are cut into n: as many as
    splits of wgrad_pts_per_split(P, n) points need, so that none is
    empty."""
    return -(-P // wgrad_pts_per_split(P, n, "bfloat16"))


def wgrad_pts_per_split(P: int, n_splits: int, compute_dtype: str = "float32") -> int:
    """Points of each wgrad split but the last (which takes the rest): P /
    n_splits rounded up to the wgrad's stage (WGRAD_STAGE; mirrors
    csrc/nerf_mlp_bwd.cu)."""
    ks = WGRAD_STAGE[compute_dtype]
    return -(-(-(-P // n_splits)) // ks) * ks


def wgrad_items(n_splits: int, kx: int, kd: int, compute_dtype: str = "float32",
                width: int = WIDTH) -> List[Tuple[int, ...]]:
    """A wgrad's work in the order of its persistent grid (mirrors
    `fill_tiles`, `item_of` and `bf16w::unit_of` in csrc/nerf_mlp_bwd.cu):
    (tile, split, rows o, columns I, offset of the entry's first row in the
    weight grad, its row length, the dz column of that row, A from the PE
    scratch (1) or the stash (0), A's first column).

    A tile is WGRAD_TILE_ROWS rows o of a weight block by all its I
    columns (the views blocks' rows are their VIEWS_LANES lanes), the wide
    tiles (A from the stash, I = width: 17 at 256, 9 at 128) first, then
    the narrow ones (A from the PE, I = kx or kd, which may equal the width
    at 128).  f32: one entry an
    item, block b taking items b, b + grid, ...: every split's wide tiles,
    split by split, then every split's narrow ones.  bf16: the unit that a
    cluster of two blocks takes at once, cluster c taking units c, c +
    clusters, ..., as block 0 then block 1 take it: the two o-halves of a
    256-row block (one tile each) or the two 64-row halves of a 128-row
    block's tile (Wvf and Wvd at width 256, every block at 128); every
    split's 9 wide units, then every split's 3 narrow ones."""
    W, Wv, T = width, VIEWS_LANES, WGRAD_TILE_ROWS
    sizes = [W * kx] + [W * W] * 4 + [W * (kx + W)] + [W * W] * 3 + [Wv * (W + kd)]
    off = [sum(sizes[:i]) for i in range(10)]
    # the 12 blocks: (offset, rows O, columns I, dz column, A from PE, A column, row length)
    jobs = ([(off[0], W, kx, 0, 1, 0, kx)]
            + [(off[l], W, W, l * W, 0, (l - 1) * W, W) for l in range(1, 5)]
            + [(off[5], W, kx, 5 * W, 1, 0, kx + W), (off[5] + kx, W, W, 5 * W, 0, 4 * W, kx + W)]
            + [(off[l], W, W, l * W, 0, (l - 1) * W, W) for l in range(6, 9)]
            + [(off[9], Wv, W, 9 * W, 0, 8 * W, W + kd),
               (off[9] + W, Wv, kd, 9 * W, 1, kx, W + kd)])
    # tiles (I, offset of row o0, row length, dz column of row o0, A from PE, A
    # column), and each block's tiles (a unit of the bf16 wgrad), wide first
    tiles, units = [], [[], []]
    for wide in (True, False):
        for o, O, I, zc, pe, ac, ldw in jobs:
            if (not pe) == wide:
                units[not wide].append(list(range(len(tiles), len(tiles) + O // T)))
                tiles += [(I, o + o0 * ldw, ldw, zc + o0, pe, ac) for o0 in range(0, O, T)]

    def entry(t, s, row0, rows):
        I, o, ldw, zc, pe, ac = tiles[t]
        return (t, s, rows, I, o + row0 * ldw, ldw, zc + row0, pe, ac)

    if compute_dtype != "bfloat16":
        return [entry(t, s, 0, T) for group in units for s in range(n_splits)
                for unit in group for t in unit]
    # a 256-row block's two tiles, one a block of the cluster; a 128-row
    # block's one tile in halves
    return [e for group in units for s in range(n_splits) for unit in group
            for e in ([entry(t, s, 0, T) for t in unit] if len(unit) == 2
                      else [entry(unit[0], s, 0, T // 2), entry(unit[0], s, T // 2, T // 2)])]


def dz_scale_units(dz: torch.Tensor) -> torch.Tensor:
    """The f32 dgrad's scale units of its dz [P, acts_ld] (the plain version
    of what it writes for the f32 wgrad; the width from the row length):
    [ceil(P / DGRAD_TILE), ZS_BLOCKS, ZS_WARPS] float32, entry (t, b, w) the
    largest 2^-r over the rows p of tile t with p % 3 == w whose block b
    (d_z0..d_z7, d_feat at 8, d_hv at 9) is not all zero, r the power of
    two that puts the row's largest |value| in [2^14, 2^15) (clamped to
    +-100, as the kernel's); 0 where no such row.  Every |value| of those
    rows is below 2^15 times it."""
    P, W = dz.shape[0], width_of_ld(dz.shape[1])
    a = dz.float().abs()
    m = torch.stack([a[:, b * W:(b + 1) * W].amax(1) for b in range(ZS_BLOCKS)], 1)
    r = (15 - torch.frexp(m).exponent).clamp(-100, 100)
    unit = torch.where(m > 0, torch.exp2(-r.float()), torch.zeros_like(m))
    n_tiles = -(-P // DGRAD_TILE)
    unit = F.pad(unit, (0, 0, 0, n_tiles * DGRAD_TILE - P)).reshape(n_tiles, DGRAD_TILE, ZS_BLOCKS)
    return torch.stack([unit[:, w::ZS_WARPS].amax(1) for w in range(ZS_WARPS)], 2)


def row_scale_exponents(m: torch.Tensor) -> torch.Tensor:
    """k for rows whose largest |value| is m: the least k >= 0 that puts m
    2^-k below 2^ROW_SCALE_BITS (m finite).  K1 f32 splits such a row into
    fp16 parts of its values times 2^-k, so that no part overflows."""
    return (torch.frexp(m.float()).exponent - ROW_SCALE_BITS).clamp_min(0)


def stash_scale_units(acts: torch.Tensor) -> torch.Tensor:
    """K1 f32's scale units of its f32 stash acts [P, acts_ld] (the plain
    version of what it writes beside the stash for the f32 wgrad; the width
    from the row length):
    [ceil(P / FWD_TILE), UNIT_BLOCKS, UNIT_WARPS] float32, entry (t, b, w)
    the largest 2^k over the rows 16 w .. 16 w + 15 of tile t before P, k
    of the row's block b (a0..a7, feat at 8) by `row_scale_exponents`; 1
    where no such row.  Every |value| of those rows is below 2^15 times
    it."""
    P, W = acts.shape[0], width_of_ld(acts.shape[1])
    m = torch.stack([acts[:, b * W:(b + 1) * W].float().abs().amax(1)
                     for b in range(UNIT_BLOCKS)], 1)
    unit = torch.exp2(row_scale_exponents(m).float())
    n_tiles = -(-P // FWD_TILE)
    unit = F.pad(unit, (0, 0, 0, n_tiles * FWD_TILE - P), value=1.0)
    unit = unit.reshape(n_tiles, UNIT_WARPS, FWD_TILE // UNIT_WARPS, UNIT_BLOCKS).amax(2)
    return unit.transpose(1, 2).contiguous()


def point_chunks(P: int, point_chunk: int) -> List[Tuple[int, int]]:
    """The backward's chunks of P points, (first point, points): point_chunk
    points rounded up to whole DGRAD_TILE-point tiles each, the last the
    rest; point_chunk 0, or one that covers P, gives one chunk."""
    chunk = -(-point_chunk // DGRAD_TILE) * DGRAD_TILE
    if chunk <= 0 or chunk >= P:
        return [(0, P)]
    return [(p0, min(chunk, P - p0)) for p0 in range(0, P, chunk)]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _pack_key(mlp, compute_dtype: str):
    return (compute_dtype, tuple((p.data_ptr(), p._version) for p in mlp.parameters()))


def _range_error(who: str) -> ValueError:
    return ValueError(f"{who}: a weight outside the f32 kernel's fp16 parts' "
                      f"range (|w| < {FP16_MAX / 2 ** SPLIT_SHIFT:g})")


def split_pieces(m: torch.Tensor, who: str) -> torch.Tensor:
    """A [N][K] block as the f32 kernels' rings stream it: chunk-major over
    K in chunks of 64 columns, each chunk as the `swizzle128` layout of its
    fp16 hi part, then its lo part, of m 2^SPLIT_SHIFT (`split_f16`).
    Raises for a value beyond the parts' range."""
    with span("sync.pack_range"):
        in_range = bool((m.abs() * 2.0 ** SPLIT_SHIFT < FP16_MAX).all())
    if not in_range:
        raise _range_error(who)
    hi, lo = (swizzle128(t) for t in split_f16(m, SPLIT_SHIFT))
    return hi_lo_chunks(hi, lo, m.shape[1] // 64)


def hi_lo_chunks(hi: torch.Tensor, lo: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Two flat chunk-major layouts of n_chunks chunks each, chunk by chunk:
    a chunk of hi, then the same chunk of lo."""
    return torch.stack([hi.reshape(n_chunks, -1), lo.reshape(n_chunks, -1)], 1).reshape(-1)


def split_f16(m: torch.Tensor, shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 kernel's two fp16 parts of x = m 2^shift: hi = fp16(x), lo =
    fp16(x - hi) (x - hi is exact in f32; hi + lo is x within ~2^-22 of it,
    or 2^-25 absolute where lo is subnormal)."""
    x = m.float() * 2.0 ** shift
    hi = x.half()
    return hi, (x - hi.float()).half()


@torch.no_grad()
def pack_params(mlp, compute_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' parameter blobs: the forward kernel's weight blob, its
    pieces in the order its ring takes them (layout in
    csrc/nerf_mlp_fwd_sm90.cuh), and the f32 blob of biases and heads
    (`layout(width)`; the views layer's padding lanes zero).
    bf16: `fwd_mats_sm90` laid out by `swizzle128`, padded with a zero piece
    to an even piece count.  f32: the same matrices (the views layer's
    pe_d chunk first) split by `split_f16` at SPLIT_SHIFT, each chunk of 64
    columns as its hi pieces, then its lo pieces, padded with zero pieces to
    a multiple of SPLIT_RING (fp16; raises for a weight beyond the parts'
    range).

    Packed once per parameter version: the result is cached on the module
    and rebuilt when a parameter is replaced or changed in place.  CPU
    parameters take torch ops (`_pack_fwd`, the plain version), whose f32
    range check reads each matrix's check on the host and raises at once.
    CUDA parameters take one launch of csrc/nerf_mlp_pack.cu (`_pack_cuda`,
    counted in `launches_pack`): the same bits and no host read.  Its f32
    range flag comes to the host behind an event and is read at this
    module's next `pack_params` call, cache hit or not, which raises the
    same ValueError there (and drops the cached blobs).
    """
    key = _pack_key(mlp, compute_dtype)
    _take_range_flag(mlp, "pack_params", "_nerf_mlp_fwd_pack")
    cached = getattr(mlp, "_nerf_mlp_fwd_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with span("mlp.pack"):
        if next(mlp.parameters()).is_cuda:
            packed = _pack_cuda(mlp, compute_dtype, forward=True)
        else:
            packed = _pack_fwd(mlp, compute_dtype)
    mlp._nerf_mlp_fwd_pack = (key, packed)
    return packed


def _pack_fwd(mlp, compute_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blobs of `pack_params`, built by torch ops."""
    if compute_dtype == "bfloat16":
        return _fwd_layout(mlp, True, lambda m: swizzle128(m.bfloat16()),
                           lambda t: t.bfloat16().float())
    return _fwd_layout(mlp, False, lambda m: split_pieces(m, "pack_params"), lambda t: t)


def _fwd_layout(mlp, bf16: bool, pieces, head) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layout of `pack_params`' blobs, for the torch ops and the pack
    kernel's maps alike: the weight blob of `fwd_mats_sm90`'s matrices (in
    f32 the views layer's PE chunk first), each laid out by pieces(m),
    padded with zero pieces; the f32 blob of biases and heads, the heads
    through head(t)."""
    w = torch.cat([pieces(m) for m in fwd_mats_sm90(mlp, views_pe_first=not bf16)])
    n_pieces = w.numel() // FWD_PIECE
    pad = n_pieces % 2 if bf16 else -n_pieces % SPLIT_RING
    if pad:
        w = torch.cat([w, w.new_zeros(pad * FWD_PIECE)])

    L, wh = layout(mlp.cfg.width), mlp.cfg.width // 2
    fp = torch.zeros(L.fp_numel, dtype=torch.float32, device=w.device)
    fp[0:L.fp_bf] = torch.cat([lin.bias for lin in mlp.pts_linears])
    fp[L.fp_bf:L.fp_bv] = mlp.feature_linear.bias
    fp[L.fp_bv:L.fp_bv + wh] = mlp.views_linears[0].bias  # the padding lanes stay 0
    fp[L.fp_ba] = mlp.alpha_linear.bias[0]
    fp[L.fp_br:L.fp_br + 3] = mlp.rgb_linear.bias
    fp[L.fp_wa:L.fp_wr] = head(mlp.alpha_linear.weight[0])
    fp[L.fp_wr:].view(3, VIEWS_LANES)[:, :wh] = head(mlp.rgb_linear.weight)
    return w, fp


def fwd_mats_sm90(mlp, views_pe_first: bool = False) -> List[torch.Tensor]:
    """The ten [out][K] matrices of the forward kernel, K in the order its
    layers read their chunks: W0 over the PE tile's first nx chunks; W1..W4;
    W5 over a4, then the PE tile's first nx chunks; W6, W7, Wf; Wv over
    feat, then the PE tile's nd chunks from chunk d0 (`pe_geometry`), or
    with `views_pe_first` (the f32 kernel) the PE chunks first, its rows
    padded with zeros to VIEWS_LANES.  A PE column a layer does not read
    gets a zero weight."""
    cfg = mlp.cfg
    in_ch, W = cfg.input_ch, cfg.width
    _, _, dx, nx, d0, nd = pe_geometry(cfg)

    def place(w, n_chunks, col0):  # w's columns at [col0, ..) of n_chunks chunks
        m = w.new_zeros((w.shape[0], 64 * n_chunks))
        m[:, col0:col0 + w.shape[1]] = w
        return m

    pts = [lin.weight for lin in mlp.pts_linears]
    wv = mlp.views_linears[0].weight
    views = [wv[:, :W], place(wv[:, W:], nd, dx - 64 * d0)]
    views = torch.cat(views[::-1] if views_pe_first else views, dim=1)
    return [
        place(pts[0], nx, 0), pts[1], pts[2], pts[3], pts[4],
        torch.cat([pts[5][:, in_ch:], place(pts[5][:, :in_ch], nx, 0)], dim=1),
        pts[6], pts[7], mlp.feature_linear.weight,
        F.pad(views, (0, 0, 0, VIEWS_LANES - views.shape[0])),
    ]


def swizzle128(m: torch.Tensor) -> torch.Tensor:
    """A [N][K] block (N a multiple of 8, K of 64) as the bf16 kernels' wgmma
    reads its B operand (csrc/hopper.cuh): chunk-major over K in chunks of
    64 columns, each chunk [N][64] row by row (128 bytes a row in bf16), and
    within each group of 8 rows the 8-column piece q of row r stored at
    piece position q ^ (r % 8).  Returns the flat chunk-major elements."""
    N, K = m.shape
    c = m.reshape(N // 8, 8, K // 64, 8, 8).permute(2, 0, 1, 3, 4)  # chunk, group, row, piece, e
    r = torch.arange(8, device=m.device)
    q = torch.arange(8, device=m.device)
    # position q of row r holds piece q ^ r
    return c[:, :, r[:, None], q[None, :] ^ r[:, None], :].reshape(-1)


def bwd_mats(mlp) -> List[torch.Tensor]:
    """The backward's 12 transposed weight blocks in f32, [in][out] with the
    PE rows past the encoding zero: W0^T [kx][W], W1^T..W4^T, W5a^T
    [kx][W], W5b^T, W6^T, W7^T, Wf^T [W][W], Wvf^T [W][VIEWS_LANES], Wvd^T
    [kd][VIEWS_LANES] (the views layer's padding lanes zero; the order of
    the dgrad's ring, csrc/nerf_mlp_dgrad.cu)."""
    cfg = mlp.cfg
    in_ch, W = cfg.input_ch, cfg.width
    kx, kd = pe_geometry(cfg)[:2]

    def padk_t(w, k):  # [out][in] -> [k][out], rows past `in` zero
        return F.pad(w, (0, k - w.shape[1])).T

    pts = [lin.weight for lin in mlp.pts_linears]
    wv = F.pad(mlp.views_linears[0].weight, (0, 0, 0, VIEWS_LANES - W // 2))
    return [padk_t(pts[0], kx)] + [pts[i].T for i in range(1, 5)] + [
        padk_t(pts[5][:, :in_ch], kx), pts[5][:, in_ch:].T, pts[6].T, pts[7].T,
        mlp.feature_linear.weight.T, wv[:, :W].T, padk_t(wv[:, W:], kd),
    ]


@torch.no_grad()
def pack_params_bwd(mlp, compute_dtype: str) -> torch.Tensor:
    """The dgrad kernel's transposed weight blob: the 12 blocks of
    `bwd_mats`, each laid out by `swizzle128` (chunk-major over its out
    columns, the layout csrc/nerf_mlp_dgrad.cu's wgmma reads).  bf16: the
    blocks rounded to bf16.  f32: each chunk of 64 columns as the fp16 hi
    part, then the lo part, of W^T 2^SPLIT_SHIFT (`split_f16`; raises for a
    weight beyond the parts' range; `split_pieces`), the pieces the f32
    dgrad's ring streams.  Cached as pack_params, and built as it is: torch
    ops on the CPU (`_pack_bwd`, the plain version, raising at once), one
    launch of csrc/nerf_mlp_pack.cu on the card, whose range flag this
    module's next `pack_params_bwd` call reads."""
    key = _pack_key(mlp, compute_dtype)
    _take_range_flag(mlp, "pack_params_bwd", "_nerf_mlp_bwd_pack")
    cached = getattr(mlp, "_nerf_mlp_bwd_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with span("mlp.pack"):
        if next(mlp.parameters()).is_cuda:
            wt = _pack_cuda(mlp, compute_dtype, forward=False)
        else:
            wt = _pack_bwd(mlp, compute_dtype)
    mlp._nerf_mlp_bwd_pack = (key, wt)
    return wt


def _pack_bwd(mlp, compute_dtype: str) -> torch.Tensor:
    """The blob of `pack_params_bwd`, built by torch ops."""
    if compute_dtype == "bfloat16":
        return torch.cat([swizzle128(m.bfloat16()) for m in bwd_mats(mlp)])
    return torch.cat([split_pieces(m, "pack_params_bwd") for m in bwd_mats(mlp)])


# The pack kernel's maps, by (MLP class, config, compute dtype, device,
# forward): the coarse and fine MLPs of a model share them
_PACK_MAPS: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


@torch.no_grad()
def pack_maps(mlp, compute_dtype: str, forward: bool) -> Tuple[torch.Tensor, ...]:
    """The pack kernel's maps on the MLP's device: int32 codes, one a blob
    element (csrc/nerf_mlp_pack.cu), of the forward pack's weight blob and
    f32 blob, or (`forward` False) of the backward pack's blob.  A code c
    is 0 for a zero fill; else |c| - 1 = j 2^PACK_OFF_BITS + i names
    element i (flat) of parameter j of `mlp.parameters()`, and c < 0 picks
    the second form (the lo part of an f32 split, a head rounded to bf16 in
    the f32 blob).

    Made once per MLP class, config, compute dtype and device by the torch
    ops' own layout code (`_fwd_layout`, `bwd_mats`, `swizzle128`,
    `hi_lo_chunks`) on a copy of the module tree whose parameters hold
    their codes (below 2^22: exact in f32), so that the layout has one
    source.  On a CUDA device nothing here reads the device."""
    p0 = next(mlp.parameters())
    key = (type(mlp), mlp.cfg, compute_dtype, p0.device, forward)
    maps = _PACK_MAPS.get(key)
    if maps is not None:
        return maps
    params = list(mlp.parameters())
    if len(params) > PACK_MAX_PARAMS or max(p.numel() for p in params) > 1 << PACK_OFF_BITS:
        raise ValueError(f"pack_maps: the pack kernel takes at most {PACK_MAX_PARAMS} "
                         f"parameters of at most 2^{PACK_OFF_BITS} elements")
    codes = _with_params(mlp, {id(p): (torch.arange(
        p.numel(), dtype=torch.float32, device=p.device) + float((j << PACK_OFF_BITS) + 1)
    ).view(p.shape) for j, p in enumerate(params)})

    bf16 = compute_dtype == "bfloat16"

    def pieces(m):  # the layout of a block; an f32 split's lo part negated
        s = swizzle128(m)
        return s if bf16 else hi_lo_chunks(s, -s, m.shape[1] // 64)

    if forward:
        blobs = _fwd_layout(codes, bf16, pieces, (lambda t: -t) if bf16 else (lambda t: t))
    else:
        blobs = (torch.cat([pieces(m) for m in bwd_mats(codes)]),)
    maps = _PACK_MAPS[key] = tuple(b.to(torch.int32) for b in blobs)
    return maps


def _with_params(module, params: dict):
    """A copy of the module tree (its own parameter and submodule tables,
    the rest shared) whose parameter p is params[id(p)]."""
    new = copy.copy(module)
    new.__dict__["_parameters"] = {k: params[id(p)] for k, p in module._parameters.items()}
    new.__dict__["_modules"] = {k: _with_params(m, params) for k, m in module._modules.items()}
    return new


def pack_gather(params, maps, compute_dtype: str) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """The pack kernel's plain version: the blobs that `pack_maps`' codes
    gather from `params` (the MLP's parameters in the order of
    `parameters()`), and whether the kernel raises its range flag: an f32
    weight w with |w| 2^SPLIT_SHIFT not below FP16_MAX, NaN or inf (never
    in bf16).  The weight blob in the compute dtype's forms (f32: fp16
    parts of w 2^SPLIT_SHIFT, hi or lo by the code's sign, `split_f16`;
    bf16: w in bf16); the f32 blob w, or w rounded to bf16 for a negative
    code."""
    size = 1 << PACK_OFF_BITS
    flat = torch.cat([F.pad(p.detach().float().reshape(-1), (0, size - p.numel()))
                      for p in params])

    def gather(c):
        return torch.where(c != 0, flat[(c.long().abs() - 1).clamp_min(0)], 0.0)

    c = maps[0]
    w = gather(c)
    if compute_dtype == "bfloat16":
        blobs, bad = [w.bfloat16()], False
    else:
        x = w * 2.0 ** SPLIT_SHIFT
        hi = x.half()
        blobs = [torch.where(c >= 0, hi, (x - hi.float()).half())]
        bad = bool((~(x.abs() < FP16_MAX)).any())
    for c in maps[1:]:
        w = gather(c)
        blobs.append(torch.where(c < 0, w.bfloat16().float(), w))
    return tuple(blobs), bad


class _RangeFlag:
    """An f32 CUDA pack's range flag on its way to the host: the device word
    the pack kernel raises to the pack's generation `gen` (1, 2, ... a pack
    of the module and kind; the word keeps the largest raised), copied to
    pinned memory behind `event` after the launch (`send`) and read at the
    module's next pack call of the same kind (`take`)."""

    def __init__(self, device: torch.device):
        self.word = torch.zeros(1, dtype=torch.int32, device=device)
        self.host = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        self.event = torch.cuda.Event()
        self.gen = 0
        self.pending = False

    def send(self, stream) -> None:
        self.host.copy_(self.word, non_blocking=True)
        self.event.record(stream)
        self.pending = True

    def take(self) -> bool:
        """Whether the pack last sent found a weight out of range.  Waits
        (a `sync.pack_range` span) only if the device has not passed the
        copy yet."""
        if not self.pending:
            return False
        self.pending = False
        if not self.event.query():
            with span("sync.pack_range"):
                self.event.synchronize()
        return int(self.host[0]) == self.gen


# each module's range flags, by pack (`who`); weak, and off the module, so
# that a module is copied and freed as before
_RANGE_FLAGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _take_range_flag(mlp, who: str, cache_attr: str) -> None:
    """Raises the range error that the module's last CUDA pack `who` found,
    dropping its cached blobs so that the next call packs (and checks)
    again."""
    flag = _RANGE_FLAGS.get(mlp, {}).get(who)
    if flag is not None and flag.take():
        setattr(mlp, cache_attr, None)
        raise _range_error(who)


def _pack_lib() -> ctypes.CDLL:
    lib = build.load(PACK_SOURCE)
    if not getattr(lib, "_lushnerf_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nerf_mlp_pack.argtypes = [vp, ci, vp, ci, vp, vp, ci, vp, ci, vp, ci, vp]
        lib.nerf_mlp_pack.restype = ci
        lib.nerf_mlp_pack_consts.argtypes = [ci]
        lib.nerf_mlp_pack_consts.restype = ci
        lib.nerf_mlp_pack_error_string.argtypes = [ci]
        lib.nerf_mlp_pack_error_string.restype = ctypes.c_char_p
        if [lib.nerf_mlp_pack_consts(i) for i in range(3)] != [
                PACK_MAX_PARAMS, PACK_OFF_BITS, SPLIT_SHIFT]:
            raise RuntimeError("nerf_mlp_pack: its codes or split differ from the CUDA source")
        lib._lushnerf_typed = True
    return lib


def _pack_cuda(mlp, compute_dtype: str, forward: bool):
    """One launch of csrc/nerf_mlp_pack.cu on the current stream: the blobs
    of `pack_params` (`forward`) or `pack_params_bwd` from the module's
    CUDA parameters in place, by `pack_maps`.  In f32 its range flag is
    sent to the host (`_RangeFlag`); nothing here waits for the device."""
    who = "pack_params" if forward else "pack_params_bwd"
    params = list(mlp.parameters())
    dev = params[0].device
    if any(p.dtype != torch.float32 or p.device != dev or not p.is_contiguous() for p in params):
        raise ValueError(f"{who}: the pack kernel reads contiguous float32 parameters on one "
                         f"device")
    bf16 = compute_dtype == "bfloat16"
    maps = pack_maps(mlp, compute_dtype, forward)
    w = torch.empty(maps[0].numel(), dtype=torch.bfloat16 if bf16 else torch.float16, device=dev)
    fp = torch.empty(maps[1].numel(), dtype=torch.float32, device=dev) if forward else None
    flag = None
    if not bf16:
        flags = _RANGE_FLAGS.setdefault(mlp, {})
        flag = flags[who] = flags.get(who) or _RangeFlag(dev)
        flag.gen += 1
    lib = _pack_lib()
    build.claim_device(dev.index)
    stream = torch.cuda.current_stream(dev)
    ptrs = (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params])
    with torch.cuda.device(dev):
        rc = lib.nerf_mlp_pack(
            ptrs, len(params), maps[0].data_ptr(), maps[0].numel(), w.data_ptr(),
            maps[1].data_ptr() if forward else None, maps[1].numel() if forward else 0,
            fp.data_ptr() if forward else None, int(bf16),
            None if flag is None else flag.word.data_ptr(), 1 if flag is None else flag.gen,
            stream.cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"nerf_mlp_pack: CUDA error {rc} "
                           f"({lib.nerf_mlp_pack_error_string(rc).decode()})")
    global launches_pack
    launches_pack += 1
    if flag is not None:
        flag.send(stream)
    return (w, fp) if forward else w


def _unpack_grads(mlp, dw: torch.Tensor, dfp: torch.Tensor) -> List[torch.Tensor]:
    """The backward's weight-blob and f32-blob grads -> the grads of
    `mlp.parameters()`; the padding columns' and the views layer's padding
    lanes' grads are dropped."""
    cfg = mlp.cfg
    in_ch, in_d, W, Wh = cfg.input_ch, cfg.input_ch_views, cfg.width, cfg.width // 2
    kx, kd = pe_geometry(cfg)[:2]
    L = layout(W)
    shapes = [(W, kx)] + [(W, W)] * 4 + [(W, kx + W)] + [(W, W)] * 3 + [(VIEWS_LANES, W + kd)]
    mats, off = [], 0
    for o, i in shapes:
        mats.append(dw[off:off + o * i].reshape(o, i))
        off += o * i
    g_w = [mats[0][:, :in_ch]] + mats[1:5] + [
        torch.cat([mats[5][:, :in_ch], mats[5][:, kx:]], dim=1), mats[6], mats[7]]
    grads = []
    for l in range(8):
        grads += [g_w[l], dfp[l * W:(l + 1) * W]]
    grads += [mats[8], dfp[L.fp_bf:L.fp_bv]]
    grads += [dfp[L.fp_wa:L.fp_wr].reshape(1, W), dfp[L.fp_ba:L.fp_ba + 1]]
    grads += [torch.cat([mats[9][:Wh, :W], mats[9][:Wh, W:W + in_d]], dim=1),
              dfp[L.fp_bv:L.fp_bv + Wh]]
    grads += [dfp[L.fp_wr:].reshape(3, VIEWS_LANES)[:, :Wh], dfp[L.fp_br:L.fp_br + 3]]
    return grads


def _lib(width: int = WIDTH) -> ctypes.CDLL:
    lib = build.load(SOURCES[0], width)
    if not getattr(lib, "_lushnerf_typed", False):
        L = layout(width)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nerf_mlp_fwd.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.nerf_mlp_fwd.restype = ci
        lib.nerf_mlp_fwd_w_numel.argtypes = [ci] * 4
        lib.nerf_mlp_fwd_w_numel.restype = ctypes.c_longlong
        lib.nerf_mlp_fwd_tile.argtypes = []
        lib.nerf_mlp_fwd_tile.restype = ci
        lib.nerf_mlp_fwd_width.argtypes = []
        lib.nerf_mlp_fwd_width.restype = ci
        lib.nerf_mlp_fwd_fp_numel.argtypes = []
        lib.nerf_mlp_fwd_fp_numel.restype = ctypes.c_longlong
        lib.nerf_mlp_fwd_acts_ld.argtypes = []
        lib.nerf_mlp_fwd_acts_ld.restype = ctypes.c_longlong
        lib.nerf_mlp_fwd_n_stages.argtypes = []
        lib.nerf_mlp_fwd_n_stages.restype = ci
        lib.nerf_mlp_fwd_units.argtypes = [ci]
        lib.nerf_mlp_fwd_units.restype = ci
        lib.nerf_mlp_fwd_pe_lanes.argtypes = []
        lib.nerf_mlp_fwd_pe_lanes.restype = ci
        lib.nerf_mlp_fwd_error_string.argtypes = [ci]
        lib.nerf_mlp_fwd_error_string.restype = ctypes.c_char_p
        if lib.nerf_mlp_fwd_width() != width or lib.nerf_mlp_fwd_fp_numel() != L.fp_numel \
                or lib.nerf_mlp_fwd_acts_ld() != L.acts_ld \
                or lib.nerf_mlp_fwd_n_stages() != len(FWD_STAGES) + len(FWD_OFF_PATH) \
                or lib.nerf_mlp_fwd_tile() != FWD_TILE or lib.nerf_mlp_fwd_pe_lanes() != PE_LANES \
                or [lib.nerf_mlp_fwd_units(i) for i in range(3)] != [
                    UNIT_BLOCKS, UNIT_WARPS, ROW_SCALE_BITS]:
            raise RuntimeError("nerf_mlp_fwd: width, f32 blob, stash layout, stages, geometry, PE "
                               "lanes or scale units differ from the CUDA source")
        lib._lushnerf_typed = True
    return lib


def _bwd_lib(width: int = WIDTH) -> ctypes.CDLL:
    lib = build.load(SOURCES[1], width)
    if not getattr(lib, "_lushnerf_typed", False):
        L = layout(width)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nerf_mlp_bwd_wgrad.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.nerf_mlp_bwd_wgrad.restype = ci
        lib.nerf_mlp_bwd_reduce_all.argtypes = [vp, ci, vp, ci, vp, vp, ci, ci, ci, vp]
        lib.nerf_mlp_bwd_reduce_all.restype = ci
        lib.nerf_mlp_bwd_consts.argtypes = [ci]
        lib.nerf_mlp_bwd_consts.restype = ci
        lib.nerf_mlp_bwd_wgrad_items.argtypes = [ci, ci, ci, ci, vp]
        lib.nerf_mlp_bwd_wgrad_items.restype = ci
        lib.nerf_mlp_bwd_w_numel.argtypes = [ci, ci]
        lib.nerf_mlp_bwd_w_numel.restype = ctypes.c_longlong
        lib.nerf_mlp_bwd_fp_numel.argtypes = []
        lib.nerf_mlp_bwd_fp_numel.restype = ctypes.c_longlong
        lib.nerf_mlp_bwd_acts_ld.argtypes = []
        lib.nerf_mlp_bwd_acts_ld.restype = ctypes.c_longlong
        lib.nerf_mlp_bwd_width.argtypes = []
        lib.nerf_mlp_bwd_width.restype = ci
        lib.nerf_mlp_bwd_error_string.argtypes = [ci]
        lib.nerf_mlp_bwd_error_string.restype = ctypes.c_char_p
        def items(dtype, kx, kd):  # the wgrad's work for a PE of kx / kd in 3 splits
            out = (ctypes.c_longlong * (9 * 24 * 3))()
            n = lib.nerf_mlp_bwd_wgrad_items(int(dtype == "bfloat16"), 3, kx, kd, out)
            return [tuple(out[9 * i:9 * i + 9]) for i in range(max(n, 0))]

        dtypes = [d for d in COMPUTE_DTYPES if width in KERNEL_WIDTHS[d]]
        if lib.nerf_mlp_bwd_width() != width or lib.nerf_mlp_bwd_fp_numel() != L.fp_numel \
                or lib.nerf_mlp_bwd_acts_ld() != L.acts_ld \
                or [lib.nerf_mlp_bwd_consts(i) for i in range(9)] != [
                    DGRAD_TILE, ZS_BLOCKS, ZS_WARPS, len(WGRAD_F32_CLOCKS),
                    len(WGRAD_BF16_CLOCKS), WGRAD_STAGE["float32"], WGRAD_STAGE["bfloat16"],
                    UNIT_BLOCKS, UNIT_WARPS] \
                or any(items(d, kx, kd) != wgrad_items(3, kx, kd, d, width) for d in dtypes
                       for kx, kd in ((64, 32), (32, 128), (128, 32))):
            raise RuntimeError("nerf_mlp_bwd: width, f32 blob, stash layout, scale units, clocks, "
                               "stages or wgrad items differ from the CUDA source")
        lib._lushnerf_typed = True
    return lib


def _dgrad_lib(width: int = WIDTH, wide_pe: bool = False) -> ctypes.CDLL:
    """The dgrads' build of the width; `wide_pe`: the one for a PE with a
    part of 128 channels (WIDE_PE_SOURCE)."""
    lib = build.load(WIDE_PE_SOURCE if wide_pe else SOURCES[2], width)
    if not getattr(lib, "_lushnerf_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nerf_mlp_dgrad_bf16.argtypes = [vp] * 10 + [ci] * 6 + [vp]
        lib.nerf_mlp_dgrad_bf16.restype = ci
        lib.nerf_mlp_dgrad_f32.argtypes = [vp] * 12 + [ci] * 6 + [vp]
        lib.nerf_mlp_dgrad_f32.restype = ci
        lib.nerf_mlp_dgrad_n_stamps.argtypes = [ci]
        lib.nerf_mlp_dgrad_n_stamps.restype = ci
        lib.nerf_mlp_dgrad_tile.argtypes = []
        lib.nerf_mlp_dgrad_tile.restype = ci
        lib.nerf_mlp_dgrad_width.argtypes = []
        lib.nerf_mlp_dgrad_width.restype = ci
        lib.nerf_mlp_dgrad_error_string.argtypes = [ci]
        lib.nerf_mlp_dgrad_error_string.restype = ctypes.c_char_p
        if lib.nerf_mlp_dgrad_width() != width or lib.nerf_mlp_dgrad_tile() != DGRAD_TILE \
                or lib.nerf_mlp_dgrad_n_stamps(0) != len(DGRAD_STAGES) + 1 \
                or lib.nerf_mlp_dgrad_n_stamps(1) != len(DGRAD_STAGES_F32) + 1 \
                + len(DGRAD_OFF_PATH_F32):
            raise RuntimeError("nerf_mlp_dgrad: width, tile or stage stamps differ from the CUDA "
                               "source")
        lib._lushnerf_typed = True
    return lib


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _needs_grad(mlp, xd: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (
        xd.requires_grad or any(p.requires_grad for p in mlp.parameters())
    )


def _check_cuda_inputs(name, mlp, xd, compute_dtype, num_freqs_x, num_freqs_d):
    if xd.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xd.device}")
    check_kernel_family(mlp.cfg, compute_dtype, num_freqs_x, num_freqs_d)
    if xd.dtype != torch.float32 or xd.dim() != 2 or xd.shape[1] != XD_CH:
        raise ValueError(f"{name}: xd must be float32 [P, {XD_CH}], got "
                         f"{xd.dtype} {tuple(xd.shape)}")


def _check_aligned(name, *tensors):
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _fwd_into(mlp, xd: torch.Tensor, compute_dtype: str, num_freqs_x: int,
              num_freqs_d: int, out: torch.Tensor, acts: Optional[torch.Tensor],
              units: Optional[torch.Tensor] = None,
              stamps: Optional[torch.Tensor] = None) -> None:
    """Launches the forward kernel (the build of the MLP's width) on
    contiguous CUDA xd [P, 8] (P > 0) into out [P, 4] and, if not None, the
    stash acts [P, acts_ld] with (f32) its scale units [ceil(P / FWD_TILE),
    UNIT_BLOCKS, UNIT_WARPS]; with `stamps` its instrumented instantiation,
    which writes its stage cycles there.  The caller counts the launch."""
    dx = pe_geometry(mlp.cfg).dx
    w, fp = pack_params(mlp, compute_dtype)
    if w.device != xd.device:
        raise ValueError(f"nerf_mlp_fwd: params on {w.device}, points on {xd.device}")
    lib = _lib(mlp.cfg.width)
    bf16 = compute_dtype == "bfloat16"
    if w.numel() != lib.nerf_mlp_fwd_w_numel(dx, num_freqs_x, num_freqs_d, int(bf16)):
        raise RuntimeError("nerf_mlp_fwd: weight blob layout differs from the CUDA source")
    if (units is None) != (bf16 or acts is None):
        raise ValueError("nerf_mlp_fwd: the f32 stash needs its scale units, and only it")
    _check_aligned("nerf_mlp_fwd", xd, w, fp, out,
                   *[t for t in (acts, units) if t is not None])
    build.claim_device(xd.device.index)
    n_blocks = fwd_grid(xd.shape[0], sm_count(xd.device))
    stream = torch.cuda.current_stream(xd.device).cuda_stream
    with torch.cuda.device(xd.device):
        rc = lib.nerf_mlp_fwd(
            xd.data_ptr(), w.data_ptr(), fp.data_ptr(), out.data_ptr(),
            None if acts is None else acts.data_ptr(),
            None if units is None else units.data_ptr(),
            None if stamps is None else stamps.data_ptr(), xd.shape[0], dx, num_freqs_x,
            num_freqs_d, int(bf16), n_blocks, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"nerf_mlp_fwd: CUDA error {rc} ({lib.nerf_mlp_fwd_error_string(rc).decode()})"
        )


def _new_stash(P: int, compute_dtype: str, device, width: int = WIDTH):
    """An empty stash [P, acts_ld] (of the width's layout) in the compute
    dtype and, in f32, its scale units (else None)."""
    acts = torch.empty((P, layout(width).acts_ld), dtype=stash_dtype(compute_dtype), device=device)
    units = None if compute_dtype == "bfloat16" else torch.empty(
        (-(-P // FWD_TILE), UNIT_BLOCKS, UNIT_WARPS), dtype=torch.float32, device=device)
    return acts, units


def _launch_fwd(mlp, xd: torch.Tensor, compute_dtype: str, num_freqs_x: int,
                num_freqs_d: int, stash: bool):
    """The forward kernel on a CUDA tensor: (raw [P, 4], stash or None, the
    f32 stash's scale units or None)."""
    _check_cuda_inputs("nerf_mlp_fwd", mlp, xd, compute_dtype, num_freqs_x, num_freqs_d)
    xd = xd.contiguous()
    P = xd.shape[0]
    out = torch.empty((P, OUT_CH), dtype=torch.float32, device=xd.device)
    acts, units = (_new_stash(P, compute_dtype, xd.device, mlp.cfg.width) if stash
                   else (None, None))
    if P == 0:
        return out, acts, units
    _fwd_into(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d, out, acts, units)
    global launches
    launches += 1
    return out, acts, units


def fwd_stage_cycles(mlp, xd: torch.Tensor, stash: bool, compute_dtype: str = "bfloat16",
                     num_freqs_x: int = 10, num_freqs_d: int = 4) -> torch.Tensor:
    """Runs the forward kernel's instrumented instantiation once on CUDA xd
    (P > 0): [tiles of block 0, len(FWD_STAGES + FWD_OFF_PATH)] int64, the
    clock64() cycles of each stage in each tile (not a launch of the main
    path: not counted)."""
    _check_cuda_inputs("nerf_mlp_fwd", mlp, xd, compute_dtype, num_freqs_x, num_freqs_d)
    xd = xd.contiguous()
    P = xd.shape[0]
    n_blocks = fwd_grid(P, sm_count(xd.device))
    stamps = torch.zeros((len(fwd_tiles(P, n_blocks)[0]), len(FWD_STAGES + FWD_OFF_PATH)),
                         dtype=torch.int64, device=xd.device)
    out = torch.empty((P, OUT_CH), dtype=torch.float32, device=xd.device)
    acts, units = (_new_stash(P, compute_dtype, xd.device, mlp.cfg.width) if stash
                   else (None, None))
    _fwd_into(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d, out, acts, units, stamps)
    return stamps


def nerf_mlp_fwd(mlp, xd: torch.Tensor, compute_dtype: str = "float32",
                 num_freqs_x: int = 10, num_freqs_d: int = 4) -> torch.Tensor:
    """Raw [P, 4] = [rgb, alpha] of the scene MLP at packed points xd [P, 8],
    without a gradient (render, torch.no_grad()).

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error;
    for a gradient call `NerfMLPFn` (as `eval_points_fused` does).
    """
    if xd.device.type == "cpu":
        return nerf_mlp_fwd_plain(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d)
    if xd.device.type == "cuda" and _needs_grad(mlp, xd):
        raise NotImplementedError(
            "nerf_mlp_fwd gives no gradient; use NerfMLPFn (eval_points_fused) or torch.no_grad()"
        )
    return _launch_fwd(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d, stash=False)[0]


class BwdLaunch:
    """The backward kernels' inputs, scratch and outputs for one call, and
    their launches: `run()` launches them (counted), `result()` returns
    (d_xd, grads) as `nerf_mlp_bwd_plain` does.  `nerf_mlp_bwd` is the one
    caller on the main path; `chip_smoke.py` also times the dgrad
    (`run(DGRAD)`) and the wgrad with its reductions (`run(WGRAD)`, on the
    scratch of an earlier dgrad) apart, and reads the dgrad's stage stamps
    (`stage_stamps()`, labelled by `stages`) and the wgrad's cycles
    (`wgrad_clocks()`, labelled by `wgrad_clock_names`); those need one
    chunk.

    The dgrad is csrc/nerf_mlp_dgrad.cu in both modes; the wgrad and
    reductions are csrc/nerf_mlp_bwd.cu's.  Without a stash (remat, K3)
    the DGRAD part first runs the forward kernel into a scratch stash, so
    K3 is K1 with its stash followed by the stash backward, and gives K2's
    bits.

    The points go in the chunks of `point_chunks(P, point_chunk)`, one
    after another, through scratch of one chunk's size (the remat stash,
    dz, the PE, the partials; in f32 the scale units), as the JAX
    package's renderer maps its `point_chunk` chunks: each chunk runs [K1,]
    the dgrad (its own rows of d(xd)), the wgrad, and the two reductions,
    which add the chunk's partials to the grads of the chunks before (the
    first chunk's store them).  Every sum keeps a fixed order, so the
    backward repeats to the bit and the stash and remat modes agree to the
    bit."""

    DGRAD, WGRAD, ALL = 1, 2, 3

    def __init__(self, mlp, xd, g, compute_dtype, num_freqs_x, num_freqs_d, acts,
                 acts_units=None, point_chunk: int = 0):
        _check_cuda_inputs("nerf_mlp_bwd", mlp, xd, compute_dtype, num_freqs_x, num_freqs_d)
        P = xd.shape[0]
        if g.shape != (P, OUT_CH) or g.device != xd.device:
            raise ValueError(f"nerf_mlp_bwd: g must be [P, {OUT_CH}] on {xd.device}")
        cdt = stash_dtype(compute_dtype)
        self.width = W = mlp.cfg.width
        L = layout(W)
        if acts is not None and (acts.shape != (P, L.acts_ld) or acts.dtype != cdt):
            raise ValueError(f"nerf_mlp_bwd: stash must be {cdt} [P, {L.acts_ld}]")
        self.mlp, self.P, self.remat = mlp, P, acts is None
        self.kx, self.kd = pe_geometry(mlp.cfg)[:2]
        self.nf = (num_freqs_x, num_freqs_d)
        self.dtype = compute_dtype
        self.bf16 = compute_dtype == "bfloat16"
        self.xd = xd.contiguous()
        self.g = g.float().contiguous()
        self.fp = pack_params(mlp, compute_dtype)[1]
        self.wt = pack_params_bwd(mlp, compute_dtype)
        self.lib = _bwd_lib(W)
        self.dlib = _dgrad_lib(W, 128 in (self.kx, self.kd))
        wn = self.lib.nerf_mlp_bwd_w_numel(self.kx, self.kd)
        if self.wt.numel() != wn * (1 if self.bf16 else 2):  # f32: hi and lo parts
            raise RuntimeError("nerf_mlp_bwd: weight blob layout differs from the CUDA source")
        dev = self.dev = xd.device
        build.claim_device(dev.index)
        new = torch.empty if P else torch.zeros  # the kernels write every value
        self.dxd = new((P, XD_CH), dtype=torch.float32, device=dev)
        self.dw = new(wn, dtype=torch.float32, device=dev)
        self.dfp = new(L.fp_numel, dtype=torch.float32, device=dev)
        if P == 0:
            return
        self.chunks = point_chunks(P, point_chunk)
        Pc = self.chunks[0][1]  # the largest chunk
        self.n_sm = sm_count(dev)
        self.n_tiles = -(-Pc // DGRAD_TILE)
        self.n_blocks = min(self.n_tiles, self.n_sm)
        # each chunk's dgrad blocks (its rows of fp_part) and wgrad splits
        # (its rows of w_part)
        self.chunk_blocks = [min(-(-n // DGRAD_TILE), self.n_sm) for _, n in self.chunks]
        self.splits = [chunk_wgrad_splits(n, compute_dtype, len(self.chunks), self.n_sm, W)
                       for _, n in self.chunks]
        if self.remat:
            self.acts, self.units = _new_stash(Pc, compute_dtype, dev, W)
            self.out = torch.empty((Pc, OUT_CH), dtype=torch.float32, device=dev)
        else:
            self.acts, self.out = acts, None
            self.units = None if self.bf16 else (
                stash_scale_units(acts) if acts_units is None else acts_units.contiguous())
        self.dz = torch.empty((Pc, L.acts_ld), dtype=cdt, device=dev)
        self.pe = torch.empty((Pc, self.kx + self.kd), dtype=cdt, device=dev)
        self.fp_part = torch.empty((self.n_blocks, L.fp_numel), dtype=torch.float32, device=dev)
        self.w_part = torch.empty((max(self.splits), wn), dtype=torch.float32, device=dev)
        # f32: the dgrad's W5a partial of d_pe_x, per block, and its scale
        # units of dz, which the wgrad reads
        self.dpe5 = self.zs = None
        if not self.bf16:
            self.dpe5 = torch.empty((self.n_blocks, DGRAD_TILE, self.kx), dtype=torch.float32,
                                    device=dev)
            self.zs = torch.empty((self.n_tiles, ZS_BLOCKS, ZS_WARPS), dtype=torch.float32,
                                  device=dev)
            if self.units.shape != (-(-(P if acts is not None else Pc) // FWD_TILE), UNIT_BLOCKS,
                                    UNIT_WARPS):
                raise ValueError("nerf_mlp_bwd: the stash's scale units have the wrong shape")
        _check_aligned("nerf_mlp_bwd", self.xd, self.g, self.wt, self.fp, self.acts, self.dz,
                       self.pe, self.dxd, self.fp_part, self.w_part, self.dw, self.dfp,
                       *([] if self.bf16 else [self.dpe5, self.zs, self.units]))

    @property
    def n_splits(self) -> int:
        """The first chunk's wgrad splits."""
        return self.splits[0]

    def _count(self, n: int) -> None:
        global launches_bwd_stash, launches_bwd_remat
        if self.remat:
            launches_bwd_remat += n
        else:
            launches_bwd_stash += n

    @staticmethod
    def _at(t: Optional[torch.Tensor], row: int) -> Optional[int]:
        """The address of row `row` of t (None for None)."""
        return None if t is None else t.data_ptr() + row * t.stride(0) * t.element_size()

    def _stash_rows(self, p0: int):
        """The chunk from point p0: (its stash rows, its scale units' rows)."""
        if self.remat:
            return self._at(self.acts, 0), self._at(self.units, 0)
        return self._at(self.acts, p0), self._at(self.units, p0 // FWD_TILE)

    def _check(self, lib, rc: int, name: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc} "
                               f"({getattr(lib, name + '_error_string')(rc).decode()})")

    def _wgrad(self, i: int = 0, clk: Optional[torch.Tensor] = None) -> None:
        p0, n = self.chunks[i]
        acts, units = self._stash_rows(p0)
        with torch.cuda.device(self.dev):
            rc = self.lib.nerf_mlp_bwd_wgrad(
                acts, self.dz.data_ptr(), self.pe.data_ptr(), self._at(self.zs, 0), units,
                self.w_part.data_ptr(), None if clk is None else clk.data_ptr(), n, self.kx,
                self.kd, int(self.bf16), self.splits[i], self.n_sm,
                torch.cuda.current_stream(self.dev).cuda_stream,
            )
        self._check(self.lib, rc, "nerf_mlp_bwd")

    def _reduce(self, i: int = 0) -> None:
        with torch.cuda.device(self.dev):
            rc = self.lib.nerf_mlp_bwd_reduce_all(
                self.fp_part.data_ptr(), self.chunk_blocks[i], self.w_part.data_ptr(),
                self.splits[i], self.dw.data_ptr(), self.dfp.data_ptr(), self.kx, self.kd,
                int(i > 0), torch.cuda.current_stream(self.dev).cuda_stream,
            )
        self._check(self.lib, rc, "nerf_mlp_bwd")

    def _dgrad(self, i: int, stamps: Optional[torch.Tensor]) -> None:
        p0, n = self.chunks[i]
        acts = self._stash_rows(p0)[0]
        common = (self._at(self.xd, p0), self._at(self.g, p0), self.wt.data_ptr(),
                  self.fp.data_ptr(), acts, self.dz.data_ptr(), self.pe.data_ptr(),
                  self._at(self.dxd, p0), self.fp_part.data_ptr())
        tail = (None if stamps is None else stamps.data_ptr(), n, self.kx, self.kd, *self.nf,
                self.chunk_blocks[i], torch.cuda.current_stream(self.dev).cuda_stream)
        with torch.cuda.device(self.dev):
            if self.bf16:
                rc = self.dlib.nerf_mlp_dgrad_bf16(*common, *tail)
            else:
                rc = self.dlib.nerf_mlp_dgrad_f32(*common, self.dpe5.data_ptr(), self.zs.data_ptr(),
                                                  *tail)
        self._check(self.dlib, rc, "nerf_mlp_dgrad")

    def run(self, parts: int = ALL, stamps: Optional[torch.Tensor] = None) -> None:
        if self.P == 0:
            return
        if parts != self.ALL and len(self.chunks) > 1:
            raise ValueError("BwdLaunch: the dgrad and the wgrad run apart on one chunk only")
        for i, (p0, n) in enumerate(self.chunks):
            if parts & self.DGRAD:
                if self.remat:  # K1 writes the stash the dgrad reads
                    _fwd_into(self.mlp, self.xd[p0:p0 + n], self.dtype, *self.nf, self.out[:n],
                              self.acts[:n], None if self.units is None else self.units[
                                  :-(-n // FWD_TILE)])
                    self._count(1)
                self._dgrad(i, stamps)
                self._count(1)
            if parts & self.WGRAD:
                self._wgrad(i)
                self._reduce(i)
                self._count(3)

    def stage_stamps(self) -> torch.Tensor:
        """Runs the dgrad once with its stage stamps on: [block 0's tiles,
        n_stamps] clock64() values, stamp i at the end of stage i of
        `stages` (stamp 0: the tile's start); in f32 then the PE warps'
        cycles by DGRAD_OFF_PATH_F32."""
        stamps = torch.zeros((-(-self.n_tiles // self.n_blocks),
                              self.dlib.nerf_mlp_dgrad_n_stamps(int(not self.bf16))),
                             dtype=torch.int64, device=self.dev)
        self.run(self.DGRAD, stamps)
        return stamps

    def wgrad_clocks(self) -> torch.Tensor:
        """Runs the wgrad's instrumented instantiation once, with its
        reductions, on the scratch of an earlier dgrad (not counted):
        [len(wgrad_clock_names)] int64 clock64() cycles of block 0."""
        if len(self.chunks) > 1:
            raise ValueError("BwdLaunch: the wgrad's cycles are read on one chunk only")
        clk = torch.zeros(len(self.wgrad_clock_names), dtype=torch.int64, device=self.dev)
        self._wgrad(0, clk)
        self._reduce()
        return clk

    @property
    def stages(self) -> List[str]:
        return DGRAD_STAGES if self.bf16 else DGRAD_STAGES_F32

    @property
    def wgrad_clock_names(self) -> Tuple[str, ...]:
        return WGRAD_BF16_CLOCKS if self.bf16 else WGRAD_F32_CLOCKS

    def result(self):
        return self.dxd, _unpack_grads(self.mlp, self.dw, self.dfp)


def nerf_mlp_bwd(mlp, xd: torch.Tensor, g: torch.Tensor, compute_dtype: str = "float32",
                 num_freqs_x: int = 10, num_freqs_d: int = 4,
                 acts: Optional[torch.Tensor] = None, acts_units: Optional[torch.Tensor] = None,
                 point_chunk: int = 0):
    """The backward kernels on CUDA tensors: (d_xd [P, 8], the grads of
    `mlp.parameters()`), as `nerf_mlp_bwd_plain` returns them.  acts: the
    forward's stash (K2, stash mode) or None (K3, remat mode: the forward
    kernel recomputes the stash into scratch allocated here and freed on
    return); acts_units: in f32 the stash's scale units as K1 wrote them
    (None: `stash_scale_units(acts)`); point_chunk: the points a chunk of
    the scratch (`point_chunks`; 0: one chunk)."""
    run = BwdLaunch(mlp, xd, g, compute_dtype, num_freqs_x, num_freqs_d, acts, acts_units,
                    point_chunk)
    run.run()
    return run.result()


class NerfMLPFn(torch.autograd.Function):
    """Raw [P, 4] of the scene MLP with a gradient for xd and every
    parameter.

    apply(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d, bwd_mode,
    point_chunk, *mlp.parameters()): the 24 parameters in the order of the
    module's parameters(), which is the order of the grads it returns.
    bwd_mode 'stash': the forward also writes the activation stash (held
    until the backward) and the backward reads it; 'remat': the backward
    recomputes the activations.  The backward's scratch covers point_chunk
    points at a time (`point_chunks`; 0: all).  CPU tensors take the plain
    versions; CUDA tensors the kernels.  The parameters are saved for the
    backward, so a parameter changed in place in between raises autograd's
    version error.
    """

    @staticmethod
    def forward(ctx, mlp, xd, compute_dtype, num_freqs_x, num_freqs_d, bwd_mode, point_chunk,
                *params):
        if bwd_mode not in BWD_MODES:
            raise ValueError(f"NerfMLPFn: bwd_mode {bwd_mode!r} not in {BWD_MODES}")
        stash = bwd_mode == "stash"
        units = None
        if xd.device.type == "cpu":
            if stash:
                out, acts = nerf_mlp_fwd_plain(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d,
                                               with_acts=True)
            else:
                out, acts = nerf_mlp_fwd_plain(mlp, xd, compute_dtype, num_freqs_x,
                                               num_freqs_d), None
        else:
            out, acts, units = _launch_fwd(mlp, xd, compute_dtype, num_freqs_x, num_freqs_d,
                                           stash)
        ctx.mlp = mlp
        ctx.args = (compute_dtype, num_freqs_x, num_freqs_d)
        ctx.point_chunk = point_chunk
        ctx.acts = (acts, units)
        ctx.save_for_backward(xd, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        xd = ctx.saved_tensors[0]  # reading them checks the params' versions
        (acts, units), ctx.acts = ctx.acts, None  # the stash is freed with the backward
        with span("mlp.bwd"):
            g = g.float().contiguous()
            if xd.device.type == "cpu":
                d_xd, grads = nerf_mlp_bwd_plain(ctx.mlp, xd, g, *ctx.args, acts=acts)
            else:
                d_xd, grads = nerf_mlp_bwd(ctx.mlp, xd, g, *ctx.args, acts=acts,
                                           acts_units=units, point_chunk=ctx.point_chunk)
        return (None, d_xd, None, None, None, None, None, *grads)


def eval_points_fused(mlp, mlp_cfg, render_cfg, pts: torch.Tensor,
                      viewdirs: torch.Tensor) -> torch.Tensor:
    """Drop-in for renderer.eval_points on the MLP family of `supports`.

    pts: [R, S, 3]; viewdirs: [R, 3].  Returns raw [R, S, 4].  Only the
    packed [P, 8] (xyz, dir) array goes in; the PE happens in the kernel.
    Where a gradient is needed the call goes through `NerfMLPFn` with
    render_cfg.mlp_bwd, its backward's scratch sized by
    render_cfg.point_chunk.
    """
    if not supports(mlp_cfg, render_cfg):
        raise NotImplementedError(
            "fused kernel supports the reference MLP family only "
            f"(depth={mlp_cfg.depth}, width={mlp_cfg.width}, skips={mlp_cfg.skips})"
        )
    if pts.dtype != torch.float32 or viewdirs.dtype != torch.float32:
        raise TypeError(f"fused kernel computes float32 only, got points in {pts.dtype} and "
                        f"viewdirs in {viewdirs.dtype}; run other dtypes with "
                        f"mlp_backend='torch'")
    R, S = pts.shape[0], pts.shape[1]
    P = R * S
    x = pts.reshape(P, 3)
    d = viewdirs[:, None, :].expand(R, S, 3).reshape(P, 3)
    xd = torch.cat([x, d, x.new_zeros(P, XD_CH - 6)], dim=-1)
    args = (render_cfg.mlp_compute_dtype, render_cfg.multires, render_cfg.multires_views)
    if _needs_grad(mlp, xd):
        raw = NerfMLPFn.apply(mlp, xd, *args, render_cfg.mlp_bwd, render_cfg.point_chunk,
                              *mlp.parameters())
    else:
        raw = nerf_mlp_fwd(mlp, xd, *args)
    return raw.reshape(R, S, OUT_CH)
