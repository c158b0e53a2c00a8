"""The f32 forward kernel's split (lushnerf_torch/csrc/nerf_mlp_fwd_sm90.cuh,
MODE_F32) on the CPU, where no kernel runs (chip_smoke.py holds the kernel
against its plain version on the card), and the routing of MLPs the
compiled kernels do not cover.  The `setup` MLP runs at both widths the f32
kernel is built for, 256 and 128 (the views layer padded to 128 lanes).
Here:
  * the f32 weight blob that `pack_params` lays out as split pieces, undone
    by a plain index model of its layout (`split_mats`), gives back each
    weight's hi part as fp16(W 2^4) exactly and (hi + lo) 2^-4 within 2^-21
    of each block's largest weight, with the zero-padded PE columns zero in
    both parts;
  * the split arithmetic read from that blob as the kernel's layers read it
    (each activation as its fp16 parts, each product as hi.hi + lo.hi +
    hi.lo in f32 at 2^4 times its value,
    bias, relu and the heads in f32) reproduces `nerf_mlp_fwd_plain` in f32
    (rtol 1e-4, atol 1e-5, the kernel's limit on the card) and its stash
    within 1e-5 of each block's largest value (the card's STASH_TOL), and
    the JAX Pallas kernel's f32 mode in interpret mode at the same limit;
  * the row scale (each activation row split at 2^-k, k the least that
    puts its largest |value| below 2^15) gives the bits of the arithmetic
    without it on ordinary inputs; on an MLP whose bias puts activations
    past fp16's 65504 (`large_activation_params`, every |w| < 4094) the
    arithmetic without it gives NaN (the control) where the plain f32
    forward and the JAX kernel's f32 mode (interpret mode) stay finite,
    and with it the output and stash are finite and within the limits
    above of both; `stash_scale_units` (the units K1 f32 writes beside its
    stash for the f32 wgrad) are, index by index, the largest 2^k of the
    stash rows of each tile's warp;
  * a width-128 member of the fused family goes, under the 'cuda' backend,
    to the fused path in both dtypes (the kernels are built for 128 in
    both; on CPU tensors its plain version, no launch: in f32 equal to the
    torch backend at the f32 limit, in bf16 to the plain bf16 forward bit
    for bit); the f32 kernel's PE geometry is part of the same predicate.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lushnerf_tpu.models.mlp import MLPConfig as JMLPConfig
from lushnerf_tpu.models.mlp import init_nerf_mlp
from lushnerf_tpu.models.renderer import RenderConfig as JRenderConfig
from lushnerf_tpu.ops.fused import nerf_mlp as jfused
from lushnerf_torch import config as cfg_mod
from lushnerf_torch.convert import mlp_state_from_jax
from lushnerf_torch.models import renderer
from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.models.renderer import RenderConfig, eval_points
from lushnerf_torch.ops.encoding import posenc
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_convert import params_like_init
from tests.test_torch_fused_mlp import F32_TOL, _xd, sm90_pe_chunks, split_mats
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

STASH_TOL = 1e-5  # chip_smoke.py's f32 stash limit: max error over the block's max value
LARGE_BIAS = 1e5  # past fp16's largest value (65504)


def large_activation_params(params):
    """A copy of the JAX params with bias column 0 of layers 0, 4 and 7 and
    of the feature layer at 1e5: a0, a4, a7 and feat each hold a column past
    fp16's range on every point (so do the views layer's and layer 5's
    inputs), while every weight stays as it was (|w| < 4094)."""
    p = jax.tree.map(np.array, params)
    for l in (0, 4, 7):
        p["pts"][l][1][0] = LARGE_BIAS
    p["feature"][1][0] = LARGE_BIAS
    return p


@pytest.fixture(scope="module", params=[256, 128], ids=["w256", "w128"])
def setup(request):
    width = request.param
    jcfg = JMLPConfig(depth=8, width=width, input_ch=63, input_ch_views=27)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg))
    mlp = NeRFMLP(MLPConfig(depth=8, width=width, input_ch=63, input_ch_views=27),
                  torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(params))
    mlp.requires_grad_(False)
    rng = np.random.default_rng(7)
    R, S = 4, 16
    pts = rng.uniform(-1, 1, (R, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jcfg, params, mlp, pts, dirs


def test_split_blob_gives_back_every_weight(setup):
    _, _, mlp, _, _ = setup
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    w, _ = fused.pack_params(mlp, "float32")
    assert w.dtype == torch.float16 and (w.numel() // fused.FWD_PIECE) % fused.SPLIT_RING == 0
    his, los = split_mats(w, kx, kd, mlp.cfg.width)
    scale = 2.0 ** fused.SPLIT_SHIFT
    # the ten f32 matrices in the f32 kernel's K order
    for want, hi, lo in zip(fused.fwd_mats_sm90(mlp, views_pe_first=True), his, los):
        assert torch.equal(hi, (want * scale).half().float())
        back = (hi.double() + lo.double()) / scale
        assert (back - want.double()).abs().max() <= 2.0 ** -21 * want.abs().max()
        assert torch.equal(hi == 0, want == 0) and not lo[want == 0].any()
    # a chunk's lo pieces follow its hi pieces
    n = mlp.cfg.width * 64
    assert w[n:2 * n].abs().max() < w[:n].abs().max() * 2.0 ** -10


def _emulate_split(w, fp, xd, kx, kd, nfx, nfd, drop_lo=False, scaled=True, width=256,
                   dx=None):
    """The f32 kernel's arithmetic read from its blob: each layer's K chunks
    in the kernel's order (W0: the pe_x chunks; W5: a4, then the pe_x
    chunks; Wv: the pe_d chunks, then feat; one or two of each: the PE tile
    holds pe_x at [0, in_ch), pe_d at [dx, dx + d_ch), dx = kx by default,
    and a layer's PE chunks are one sum, as the MULTI instantiation takes
    them one fill of its slot after another), every activation row split
    in the fp16 parts of its values times 2^-k (k of `fused.row_scale_exponents` of the
    row's largest |value|; `scaled=False`: k = 0, the arithmetic without
    the row scale) and the PE unscaled (the blob holds the parts of W 2^4),
    acc = 2^4 2^-k bias + hi(A) hi(W) + lo(A) hi(W) + hi(A) lo(W) in f32,
    relu(acc 2^k 2^-4) in f32; layer 5 takes its rows back by 2^k before its
    PE chunk and the views layer scales them by 2^-k after its own, each
    only where some row has k > 0; the heads on the f32 activations.
    Returns (raw out, stash).  `drop_lo`: the lo parts as zeros (the
    control: fp16 products).  At the MLP's `width` (the views layer's 128
    lanes at both: the f32 blob's layout, `fused.layout(width)`)."""
    dx, d_ch = (kx if dx is None else dx), 3 + 6 * nfd
    his, los = split_mats(w, kx, kd, width, dx, d_ch)
    nx, d0, nd = sm90_pe_chunks(kx, kd, dx, d_ch)
    Wd, Wh = width, 128
    L = fused.layout(width)
    acc_scale = 2.0 ** fused.SPLIT_SHIFT

    def split(t):
        hi, lo = fused.split_f16(t, 0)
        return hi.float(), lo.float() * (not drop_lo)

    def down(a, relu):  # the rows' 2^-k, [P, 1]
        if not scaled:
            return torch.ones(a.shape[0], 1)
        m = (a if relu else a.abs()).amax(1)
        return torch.exp2(-fused.row_scale_exponents(m).float())[:, None]

    def products(a, wh, wl):
        ah, al = split(a)
        return ah @ wh.T + al @ wh.T + ah @ wl.T

    def layer(i, a, s, bias, relu=True, pe=None, pe_first=False):
        """a: the input activations, whose rows were split times s; pe: the
        layer's PE chunk, read after a (layer 5) or before it (pe_first)."""
        wh, wl = his[i], los[i] * (not drop_lo)
        rescale = pe is not None and bool((s < 1).any())
        if pe is None or not rescale:  # one sum over the layer's chunks in order
            x = a * s if pe is None else torch.cat([pe, a * s] if pe_first else [a * s, pe], 1)
            b = bias * acc_scale * (1.0 if pe_first else s)
            acc = (b + products(x, wh, wl)) * ((1.0 / s if pe is None or pe_first else 1.0)
                                               / acc_scale)
        else:
            k_pe = pe.shape[1]
            if pe_first:  # Wv: the PE chunk, then the rows times 2^-k, then feat
                acc = (bias * acc_scale + products(pe, wh[:, :k_pe], wl[:, :k_pe])) * s
                acc = (acc + products(a * s, wh[:, k_pe:], wl[:, k_pe:])) * (1.0 / s / acc_scale)
            else:  # W5: a4, the rows times 2^k, then the PE chunk
                k_a = a.shape[1]
                acc = (bias * acc_scale * s + products(a * s, wh[:, :k_a], wl[:, :k_a])) / s
                acc = (acc + products(pe, wh[:, k_a:], wl[:, k_a:])) / acc_scale
        out = torch.relu(acc) if relu else acc
        return out, down(out, relu)

    P = xd.shape[0]
    pe = torch.zeros((P, 128))
    pe[:, :3 + 6 * nfx] = posenc(xd[:, 0:3], nfx)
    pe[:, dx:dx + d_ch] = posenc(xd[:, 3:6], nfd)
    pe_x, pe_d = pe[:, :64 * nx], pe[:, 64 * d0:64 * (d0 + nd)]
    b = lambda i: fp[i * Wd:(i + 1) * Wd]  # noqa: E731
    one = torch.ones(P, 1)
    a, s = layer(0, pe_x, one, b(0))
    acts = [a]
    for i in range(1, 5):
        a, s = layer(i, a, s, b(i))
        acts.append(a)
    a, s = layer(5, a, s, b(5), pe=pe_x)
    acts.append(a)
    for i in (6, 7):
        a, s = layer(i, a, s, b(i))
        acts.append(a)
    alpha = acts[7] @ fp[L.fp_wa:L.fp_wr] + fp[L.fp_ba]
    feat, s = layer(8, a, s, fp[L.fp_bf:L.fp_bv], relu=False)
    hv, _ = layer(9, feat, s, fp[L.fp_bv:L.fp_ba], pe=pe_d, pe_first=True)
    rgb = hv @ fp[L.fp_wr:].reshape(3, Wh).T + fp[L.fp_br:L.fp_br + 3]
    return torch.cat([rgb, alpha[:, None]], 1), torch.cat(acts + [feat, hv], 1)


def _stash_rel_err(got, want):
    w = fused.width_of_ld(want.shape[1])
    blocks = [(l * w, (l + 1) * w) for l in range(9)] + [(9 * w, 9 * w + w // 2)]
    return max(((got[:, a:b] - want[:, a:b]).abs().max() / want[:, a:b].abs().max()).item()
               for a, b in blocks)


@pytest.mark.parametrize("S", [16, 7], ids=["tile", "ragged"])
def test_split_reproduces_plain_f32(setup, S):
    _, _, mlp, pts, dirs = setup
    xd = _xd(pts[:, :S], dirs)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    width = mlp.cfg.width
    w, fp = fused.pack_params(mlp, "float32")
    out, stash = _emulate_split(w, fp, xd, kx, kd, 10, 4, width=width)
    want, want_stash = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **F32_TOL)
    assert stash.shape == want_stash.shape == (xd.shape[0], fused.layout(width).acts_ld)
    assert _stash_rel_err(stash, want_stash) <= STASH_TOL
    # the views layer's padding lanes: 0 in both
    assert not stash[:, 9 * width + width // 2:].any() and not want_stash[:, 9 * width + width // 2:].any()
    # the control: without the lo parts (fp16 products) the stash fails its
    # limit tenfold and the output moves tenfold
    out_f16, stash_f16 = _emulate_split(w, fp, xd, kx, kd, 10, 4, drop_lo=True, width=width)
    assert _stash_rel_err(stash_f16, want_stash) > 10 * STASH_TOL
    assert (out_f16 - want).abs().max() > 10 * (out - want).abs().max()


def test_split_reproduces_jax_kernel_f32(setup):
    jcfg, params, mlp, pts, dirs = setup
    with pltpu.force_tpu_interpret_mode():
        want = jfused.eval_points_fused(
            params, jcfg, JRenderConfig(mlp_compute_dtype="float32"),
            jnp.asarray(pts), jnp.asarray(dirs), tile=16,
        )
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    w, fp = fused.pack_params(mlp, "float32")
    got, _ = _emulate_split(w, fp, _xd(pts, dirs), kx, kd, 10, 4, width=mlp.cfg.width)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), np.asarray(want), **F32_TOL)


def test_row_scale_keeps_the_bits_of_ordinary_inputs(setup):
    _, _, mlp, pts, dirs = setup
    xd = _xd(pts, dirs)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    w, fp = fused.pack_params(mlp, "float32")
    out, stash = _emulate_split(w, fp, xd, kx, kd, 10, 4, width=mlp.cfg.width)
    out_u, stash_u = _emulate_split(w, fp, xd, kx, kd, 10, 4, scaled=False, width=mlp.cfg.width)
    assert stash.abs().max() < 2.0 ** fused.ROW_SCALE_BITS
    assert torch.equal(out, out_u) and torch.equal(stash, stash_u)


def _jax_f32(params, jcfg, pts, dirs):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jfused.eval_points_fused(
            params, jcfg, JRenderConfig(mlp_compute_dtype="float32"),
            jnp.asarray(pts), jnp.asarray(dirs), tile=16))


def test_row_scale_keeps_large_activations_finite(setup):
    jcfg, params, _, pts, dirs = setup
    big = large_activation_params(params)
    width = jcfg.width
    mlp = NeRFMLP(MLPConfig(depth=8, width=width, input_ch=63, input_ch_views=27),
                  torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(big))
    mlp.requires_grad_(False)
    xd = _xd(pts, dirs)
    want, want_stash = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    assert want_stash.abs().max() >= 65520 and bool(torch.isfinite(want).all())
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    w, fp = fused.pack_params(mlp, "float32")  # every weight in the parts' range
    # the control: the arithmetic without the row scale overflows to NaN
    bad, _ = _emulate_split(w, fp, xd, kx, kd, 10, 4, scaled=False, width=width)
    assert bool(torch.isnan(bad).any())
    jax_out = _jax_f32(big, jcfg, pts, dirs)
    assert np.isfinite(jax_out).all()
    got, stash = _emulate_split(w, fp, xd, kx, kd, 10, 4, width=width)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(stash).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    assert _stash_rel_err(stash, want_stash) <= STASH_TOL
    np.testing.assert_allclose(got.numpy().reshape(jax_out.shape), jax_out, **F32_TOL)


@pytest.mark.parametrize("big", [False, True], ids=["ordinary", "large"])
def test_stash_scale_units_by_index(setup, big):
    """Units over 300 points (three tiles, the last ragged): entry (t, b, w)
    the largest 2^k over the rows 16 w .. 16 w + 15 of tile t of block b,
    k of `row_scale_exponents`; 1 past P; every unit 1 on ordinary input."""
    jcfg, params, _, _, _ = setup
    width = jcfg.width
    mlp = NeRFMLP(MLPConfig(depth=8, width=width, input_ch=63, input_ch_views=27),
                  torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(large_activation_params(params) if big else params))
    rng = np.random.default_rng(17)
    pts = rng.uniform(-1, 1, (3, 100, 3)).astype(np.float32)
    dirs = rng.standard_normal((3, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    with torch.no_grad():
        _, stash = fused.nerf_mlp_fwd_plain(mlp, _xd(pts, dirs), "float32", with_acts=True)
    units = fused.stash_scale_units(stash)
    P, T = stash.shape[0], fused.FWD_TILE
    assert units.shape == (-(-P // T), fused.UNIT_BLOCKS, fused.UNIT_WARPS)
    assert units.dtype == torch.float32
    for b in range(fused.UNIT_BLOCKS):
        m = stash[:, width * b:width * (b + 1)].abs().amax(1)
        k = fused.row_scale_exponents(m)
        for t in range(units.shape[0]):
            for w in range(fused.UNIT_WARPS):
                rows = range(t * T + 16 * w, min(P, t * T + 16 * (w + 1)))
                want = max((2.0 ** int(k[p]) for p in rows), default=1.0)
                assert units[t, b, w].item() == want, (b, t, w)
    assert bool((units > 1).any()) == big
    if big:  # the blocks of a0, a4, a7 and feat, and only those, carry a scale
        assert set(torch.nonzero((units > 1).any(2).any(0)).flatten().tolist()) == {0, 4, 7, 8}


def _width128_model():
    cfg = cfg_mod.flagship_cfg(num_images=3, tiny=True)
    cfg.netdepth = cfg.netdepth_fine = 8
    cfg.netwidth = cfg.netwidth_fine = 128
    cfg.multires, cfg.multires_views = 10, 4
    cfg.mlp_backend = "cuda"
    lc = cfg.lush_config()
    mlp_cfg = lc.mlp_cfg_fine
    mlp = NeRFMLP(mlp_cfg, torch.Generator().manual_seed(2), torch.device("cpu")).requires_grad_(False)
    return lc, mlp_cfg, mlp


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_width128_routes_to_plain_path(dtype, monkeypatch):
    """flagship_cfg's shape at width 128 (in the fused family) under the
    'cuda' backend, in both dtypes routed into the fused path (the kernels
    are built for 128 in both), which on CPU tensors runs its plain version
    and launches nothing.  f32: equal to the torch backend at the f32
    limit.  bf16: the plain bf16 forward of the packed points bit for bit,
    not the torch backend's f32 MLP (the bf16 rounding is on)."""
    lc, mlp_cfg, mlp = _width128_model()
    rc = RenderConfig(mlp_backend="cuda", mlp_compute_dtype=dtype)
    bf16 = dtype == "bfloat16"
    assert mlp_cfg.width == 128 and fused.supports(mlp_cfg, rc)
    assert fused.kernel_covers(mlp_cfg, rc)
    calls = []
    real = fused.eval_points_fused
    monkeypatch.setattr(fused, "eval_points_fused",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, 6, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((3, 3)).astype(np.float32)), dim=-1)
    fused.launches = 0
    got = eval_points(mlp, mlp_cfg, rc, pts, dirs)
    want = eval_points(mlp, mlp_cfg, RenderConfig(mlp_backend="torch"), pts, dirs)
    assert len(calls) == 1 and fused.launches == 0
    fused.check_kernel_family(mlp_cfg, dtype, 10, 4)
    if bf16:
        xd = _xd(pts.numpy(), dirs.numpy())
        assert torch.equal(got.reshape(-1, 4), fused.nerf_mlp_fwd_plain(mlp, xd, dtype))
        assert not torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    assert renderer.fused is fused


def test_kernel_covers_follows_the_kernels_geometry():
    """What each mode's kernels cover.  Width 256: the flagship PE in both;
    a pe_x of 96 padded channels in both (the f32 kernel fills its one PE
    slot once a chunk); pe_x of 32 with pe_d in the same chunk in both, and
    with pe_d over two chunks; PEs whose padded widths pass 128 (12/8, 16/4,
    4/16: the forward packs them tightly, as the JAX kernels do) in both.
    Width 128: each dtype the PE geometry it has at 256 (the PE tile and
    the dgrad's PE passes do not depend on the width).  Widths 384 and 512:
    nothing."""
    cases = {(256, 10, 4): (True, True), (256, 15, 4): (True, True),
             (256, 4, 4): (True, True), (256, 4, 9): (True, True),
             (128, 10, 4): (True, True), (128, 15, 4): (True, True),
             (128, 4, 4): (True, True), (128, 4, 9): (True, True),
             (384, 10, 4): (False, False), (512, 10, 4): (False, False),
             (256, 12, 8): (True, True), (256, 16, 4): (True, True),
             (256, 4, 16): (True, True)}
    for (width, nfx, nfd), want in cases.items():
        cfg = MLPConfig(width=width, input_ch=3 + 6 * nfx, input_ch_views=3 + 6 * nfd)
        got = tuple(fused.kernel_covers(cfg, RenderConfig(mlp_backend="cuda", mlp_compute_dtype=dt,
                                                          multires=nfx, multires_views=nfd))
                    for dt in ("bfloat16", "float32"))
        assert got == want, (width, nfx, nfd, got)
        assert (fused.kernel_gap(cfg, "float32", nfx, nfd) is None) == want[1]


def test_fwd_ablate_patches_match_the_source():
    """The f32 forward's ablation tool patches csrc/nerf_mlp_fwd_sm90.cuh by
    text: every text it replaces is in the header, once."""
    from lushnerf_torch.ops.fused import build
    from lushnerf_torch.scripts import fwd_ablate
    src = (build.CSRC / fwd_ablate.HEADER).read_text()
    for variant, patches in fwd_ablate.PATCHES.items():
        for old, _ in patches:
            assert src.count(old) == 1, variant
