"""Every positional encoding the JAX package's fused kernels run, through the
port's kernels' geometry, on the CPU.

The JAX kernels take every MLP whose two PEs share one 128-lane register
(in_ch + d_ch <= 128, `supports`); the port's backward pads each PE to 32
channels (kx + kd up to 160) and its forward packs them into a 128-column
PE tile, tightly where the padded widths pass 128 (`pe_geometry`).  The
kernels run only on the card (chip_smoke.py's `pe` phase holds them against
their plain versions there); here, from numpy seeds:
  * routing: for all 231 (multires, multires_views) pairs with 6 (a + b) +
    6 <= 128, and the pairs one past them, at widths 128, 256, 384 and 512
    in both dtypes, `kernel_covers` is the JAX package's `supports` at the
    widths the kernels are built for (128, 256) and False past them, and
    `kernel_gap` names no PE inside the domain; every geometry keeps pe_x
    and pe_d apart inside the tile and within two chunks;
  * blobs: at 12/4, 4/9, 4/12, 12/8, 16/4 and 4/16 (width 128) the bf16 and
    the f32-split forward blobs, undone by the index models of their
    layouts (`sm90_mats`, `split_mats`), give back every weight at its PE
    columns; the wgrad's work table (`wgrad_items`) takes every weight-grad
    entry once a split at PE parts of up to 128 columns, at widths 256 and
    128 (where such a part is as wide as the layers);
  * weights: `params_from_jax` carries a whole model's JAX params at 12/8
    into the port's LushNeRF and back bit for bit;
  * parity with JAX: at those PEs (width 128; 12/8 also at 256) the port's
    forward against `eval_points_fused` in interpret mode (tile 16, 2 rays
    x 16 samples): in f32 the plain version and the split's emulation
    within F32_TOL, in bf16 the plain version and the bf16 kernel's
    emulation within BF16_TOL (tests/test_torch_fused_mlp.py's limits);
    at 12/8 and 16/4 the grads of NerfMLPFn on CPU tensors against jax.grad
    through the same JAX path at tests/test_torch_fused_mlp_bwd.py's
    limits, f32 remat and bf16 stash.  Past 10 frequencies the coordinates
    are scaled by powers of two so that the largest PE argument is the
    shipped PE's (`arg_scale`); at the full range the JAX kernel's own PE
    rounds its cos lanes' argument, which is the whole gap there (held by
    `test_jax_pe_rounding_is_the_gap_at_full_range`).
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
import __graft_entry__ as ge
from lushnerf_torch.config import flagship_cfg
from lushnerf_torch.convert import mlp_state_from_jax, params_from_jax, params_to_jax
from lushnerf_torch.models.lushnerf import LushNeRF
from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.models.renderer import RenderConfig
from lushnerf_torch.ops.encoding import posenc
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_convert import _assert_tree_equal, jax_params, params_like_init
from tests.test_torch_fused_mlp import BF16_TOL, F32_TOL, _xd, sm90_mats, split_mats
from tests.test_torch_fused_mlp_bwd import _assert_grads
from tests.test_torch_fused_mlp_f32split import _emulate_split
from tests.test_torch_fused_mlp_sm90 import _emulate_sm90
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

# every (multires, multires_views) whose PE fits the JAX kernels' 128 lanes
PAIRS = [(a, b) for a in range(21) for b in range(21 - a)]
# the geometries the kernels did not run before: pe_x over two chunks
# (12/4), pe_d over two (4/9, 4/12), padded widths past 128 (12/8, 16/4, 4/16)
GEOS = {"12/4": (12, 4), "4/9": (4, 9), "4/12": (4, 12), "12/8": (12, 8), "16/4": (16, 4),
        "4/16": (4, 16)}
DTYPES = ("float32", "bfloat16")


def _cfgs(width, nfx, nfd):
    kw = dict(depth=8, width=width, input_ch=3 + 6 * nfx, input_ch_views=3 + 6 * nfd)
    return MLPConfig(**kw), JMLPConfig(**kw)


def test_kernel_covers_every_pe_the_jax_kernels_run():
    assert len(PAIRS) == 231
    past = [(a, 21 - a) for a in range(22)]  # 6 (a + b) + 6 = 132: one step past the lanes
    for width in (128, 256, 384, 512):
        for nfx, nfd in PAIRS + past:
            cfg, jcfg = _cfgs(width, nfx, nfd)
            want = jfused.supports(jcfg, JRenderConfig()) and width in (128, 256)
            assert want == ((nfx, nfd) in PAIRS and width in (128, 256)), (width, nfx, nfd)
            for dt in DTYPES:
                rc = RenderConfig(mlp_backend="cuda", mlp_compute_dtype=dt, multires=nfx,
                                  multires_views=nfd)
                assert fused.supports(cfg, rc) == jfused.supports(jcfg, JRenderConfig())
                assert fused.kernel_covers(cfg, rc) == want, (width, nfx, nfd, dt)
                gap = fused.kernel_gap(cfg, dt, nfx, nfd)
                assert (gap is None) == want
                if width in (128, 256) and not want:
                    assert "PE lanes" in gap
                    with pytest.raises(ValueError):
                        fused.check_kernel_family(cfg, dt, nfx, nfd)


@pytest.mark.parametrize("pair", PAIRS[::7] + [GEOS[g] for g in GEOS], ids=str)
def test_pe_geometry_keeps_the_parts_apart(pair):
    """pe_x at [0, in_ch), pe_d at [dx, dx + d_ch) inside the 128 columns,
    apart; dx the padded kx where kx + kd <= 128 (the layout of the PEs the
    kernels ran before), else in_ch (the JAX kernels' tight packing); the
    chunks W0 / W5 and Wv read cover their part."""
    nfx, nfd = pair
    cfg, _ = _cfgs(256, nfx, nfd)
    in_ch, d_ch = cfg.input_ch, cfg.input_ch_views
    kx, kd, dx, nx, d0, nd = fused.pe_geometry(cfg)
    assert (kx, kd) == (-(-in_ch // 32) * 32, -(-d_ch // 32) * 32)
    assert kx <= 128 and kd <= 128 and kx + kd <= fused.PE_PAD_MAX
    assert dx == (kx if kx + kd <= fused.PE_LANES else in_ch)
    assert in_ch <= dx and dx + d_ch <= fused.PE_LANES
    assert 64 * nx >= in_ch and 64 * (nx - 1) < in_ch and nx <= 2
    assert 64 * d0 <= dx and 64 * (d0 + nd) >= dx + d_ch and d0 + nd <= 2


def _placed(m, n_chunks, col0, rows=None):
    out = torch.zeros(rows or m.shape[0], 64 * n_chunks)
    out[:m.shape[0], col0:col0 + m.shape[1]] = m
    return out


def _want_mats(mlp, views_pe_first):
    """The ten matrices of the forward blobs, written out from the
    parameters and the geometry: W0 over nx chunks, W5 over a4 then nx
    chunks, Wv over feat and the nd chunks from d0 (pe_d at dx - 64 d0),
    the views layer's rows padded to 128."""
    W = mlp.cfg.width
    in_ch = mlp.cfg.input_ch
    _, _, dx, nx, d0, nd = fused.pe_geometry(mlp.cfg)
    pts = [lin.weight for lin in mlp.pts_linears]
    wv = mlp.views_linears[0].weight
    views = [_placed(wv[:, :W], W // 64, 0, 128), _placed(wv[:, W:], nd, dx - 64 * d0, 128)]
    return [_placed(pts[0], nx, 0)] + pts[1:5] + [
        torch.cat([pts[5][:, in_ch:], _placed(pts[5][:, :in_ch], nx, 0)], 1)] + pts[6:8] + [
        mlp.feature_linear.weight, torch.cat(views[::-1] if views_pe_first else views, 1)]


@pytest.mark.parametrize("geo", list(GEOS))
def test_blobs_give_back_every_weight(geo):
    nfx, nfd = GEOS[geo]
    cfg, _ = _cfgs(128, nfx, nfd)
    mlp = NeRFMLP(cfg, torch.Generator().manual_seed(1), torch.device("cpu")).requires_grad_(False)
    kx, kd, dx, nx, d0, nd = fused.pe_geometry(cfg)
    d_ch = cfg.input_ch_views
    # bf16: one [128][64] piece a chunk at width 128, padded to an even count
    w, _ = fused.pack_params(mlp, "bfloat16")
    n = 2 * nx + 16 + 2 + nd
    assert w.dtype == torch.bfloat16 and w.numel() // (128 * 64) == n + n % 2
    got = sm90_mats(w, kx, kd, 128, dx, d_ch)
    want = _want_mats(mlp, views_pe_first=False)
    assert [tuple(m.shape) for m in got] == [tuple(m.shape) for m in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.bfloat16().float().numpy())
    # f32: each chunk's fp16 hi pieces, then its lo pieces, of W 2^4; the
    # views layer's PE chunks first; zero pieces up to a multiple of 4
    w, _ = fused.pack_params(mlp, "float32")
    n = 2 * (2 * nx + 16) + 2 * (2 + nd)
    assert w.dtype == torch.float16 and w.numel() // (128 * 64) == -(-n // 4) * 4
    his, los = split_mats(w, kx, kd, 128, dx, d_ch)
    scale = 2.0 ** fused.SPLIT_SHIFT
    for want_m, hi, lo in zip(_want_mats(mlp, views_pe_first=True), his, los):
        assert torch.equal(hi, (want_m * scale).half().float())
        back = (hi.double() + lo.double()) / scale
        assert (back - want_m.double()).abs().max() <= 2.0 ** -21 * want_m.abs().max()
        assert torch.equal(hi == 0, want_m == 0) and not lo[want_m == 0].any()


def arg_scale(n_freqs):
    """The factor on a coordinate that keeps its PE's largest argument
    2^(L - 1) |x| at the shipped 10 frequencies' (2^9 |x|) for L > 10.  The
    JAX kernel's cos lanes take sin(2^j x + pi / 2) in f32, so their argument
    rounds at half an ulp of 2^j |x| (2^-8 at L = 16 on unit coordinates,
    against 2^-14 at L = 10): the existing limits were set at the shipped
    range, and the full range is held apart
    (`test_jax_pe_rounding_is_the_gap_at_full_range`)."""
    return 2.0 ** min(0, 10 - n_freqs)


@pytest.mark.parametrize("width", [256, 128])
def test_wgrad_items_take_every_entry_once(width):
    """The wgrad's work table at the padded widths of the new PEs (kx or kd
    up to 128, kx + kd up to 160; at width 128 a PE part of 128 columns is
    as wide as the layers), in both dtypes over 3 splits: every weight-grad
    entry once a split; the items reading the PE scratch are W0's and
    W5a's (I = kx, A from column 0) and Wvd's (I = kd, from column kx), the
    wide ones (I = width) read the stash and come first."""
    for kx, kd in [(32, 128), (128, 32), (96, 64), (64, 32)]:
        numel = width * kx + 7 * width * width + width * (kx + width) + 128 * (width + kd)
        for dtype in DTYPES:
            items = fused.wgrad_items(3, kx, kd, dtype, width)
            seen = np.zeros((3, numel), np.int8)
            for _, split, rows, I, off, ldw, _, from_pe, a_col in items:
                seen[split, off + np.arange(rows)[:, None] * ldw + np.arange(I)[None, :]] += 1
                assert (I, a_col) in ([(kx, 0), (kd, kx)] if from_pe else [(width, a_col)])
            assert (seen == 1).all(), (kx, kd, dtype)
            pe = [it[7] for it in items]
            assert pe == sorted(pe)  # the wide items first


def test_weights_carry_across_at_a_denser_pe():
    """`convert.params_from_jax` at the 12/8 PE: the JAX package's params
    of a whole (tiny) model load into the port's LushNeRF strictly, its
    scene MLPs take 75 / 51 PE inputs, and `params_to_jax` gives them back
    bit for bit."""
    jcfg, cfg = ge._flagship_cfg(3, tiny=True), flagship_cfg(3, tiny=True)
    for c in (jcfg, cfg):
        c.multires, c.multires_views = GEOS["12/8"]
    params = jax_params(jcfg.lush_config(), seed=3)
    model = LushNeRF(cfg.lush_config(), seed=1, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    assert (model.mlp_fine.cfg.input_ch, model.mlp_fine.cfg.input_ch_views) == (75, 51)
    _assert_tree_equal(params_to_jax(model.state_dict()), params)


def _setup(width, nfx, nfd, seed=3, scaled=True):
    _, jcfg = _cfgs(width, nfx, nfd)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg), seed=seed)
    mlp = NeRFMLP(MLPConfig(**{k: getattr(jcfg, k) for k in ("depth", "width", "input_ch",
                                                              "input_ch_views")}),
                  torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(params))
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((2, 16, 3)).astype(np.float32)
    dirs = rng.standard_normal((2, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    if scaled:  # powers of two: exact
        pts, dirs = pts * np.float32(arg_scale(nfx)), dirs * np.float32(arg_scale(nfd))
    return jcfg, params, mlp, pts, dirs


def _jax_rc(dtype, nfx, nfd, **kw):
    return JRenderConfig(mlp_compute_dtype=dtype, multires=nfx, multires_views=nfd, **kw)


@pytest.mark.parametrize("geo,width", [(g, 128) for g in GEOS] + [("12/8", 256)],
                         ids=[f"{g}-w128" for g in GEOS] + ["12/8-w256"])
def test_forward_matches_jax_kernel(geo, width):
    nfx, nfd = GEOS[geo]
    jcfg, params, mlp, pts, dirs = _setup(width, nfx, nfd)
    mlp.requires_grad_(False)
    xd = _xd(pts, dirs)
    kx, kd, dx = fused.pe_geometry(mlp.cfg)[:3]
    for dtype in DTYPES:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jfused.eval_points_fused(params, jcfg, _jax_rc(dtype, nfx, nfd),
                                                       jnp.asarray(pts), jnp.asarray(dirs),
                                                       tile=16)).reshape(-1, 4)
        assert np.isfinite(want).all()
        plain = fused.nerf_mlp_fwd_plain(mlp, xd, dtype, nfx, nfd)
        if dtype == "float32":
            w, fp = fused.pack_params(mlp, dtype)
            kernel, _ = _emulate_split(w, fp, xd, kx, kd, nfx, nfd, width=width, dx=dx)
            tol = F32_TOL
        else:
            kernel, tol = _emulate_sm90(mlp, xd, nfx, nfd), BF16_TOL
        np.testing.assert_allclose(plain.numpy(), want, **tol)
        np.testing.assert_allclose(kernel.numpy(), want, **tol)


def _jax_grads(params, jcfg, pts, dirs, dtype, mode, nfx, nfd):
    """(d pts, d dirs, {name: grad}) of sum(sin(raw) * [0, 1, 2, 3]) through
    the JAX Pallas kernel at the PE of nfx / nfd frequencies."""
    rc = _jax_rc(dtype, nfx, nfd, mlp_bwd=mode)

    def loss(p, x, d):
        raw = jfused.eval_points_fused(p, jcfg, rc, x, d, tile=16)
        return jnp.sum(jnp.sin(raw) * jnp.arange(4))

    with pltpu.force_tpu_interpret_mode():
        gp, gx, gd = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(pts), jnp.asarray(dirs))
    gp = jax.tree.map(np.asarray, gp)
    return np.asarray(gx), np.asarray(gd), {k: v.numpy() for k, v in mlp_state_from_jax(gp).items()}


@pytest.mark.parametrize("geo,dtype,mode", [("12/8", "float32", "remat"),
                                            ("16/4", "float32", "remat"),
                                            ("12/8", "bfloat16", "stash"),
                                            ("16/4", "bfloat16", "stash")])
def test_grads_match_jax_kernel(geo, dtype, mode):
    nfx, nfd = GEOS[geo]
    jcfg, params, mlp, pts, dirs = _setup(128, nfx, nfd)
    want = _jax_grads(params, jcfg, pts, dirs, dtype, mode, nfx, nfd)
    x = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    fused.launches = fused.launches_bwd_stash = fused.launches_bwd_remat = 0
    rc = RenderConfig(mlp_backend="cuda", mlp_compute_dtype=dtype, mlp_bwd=mode, multires=nfx,
                      multires_views=nfd)
    raw = fused.eval_points_fused(mlp, mlp.cfg, rc, x, d)
    loss = torch.sum(torch.sin(raw) * torch.arange(4, dtype=torch.float32))
    grads = torch.autograd.grad(loss, [x, d] + list(mlp.parameters()))
    assert fused.launches == fused.launches_bwd_stash == fused.launches_bwd_remat == 0
    names = [n for n, _ in mlp.named_parameters()]
    got = (grads[0].numpy(), grads[1].numpy(), {n: g.numpy() for n, g in zip(names, grads[2:])})
    _assert_grads(got, want, dtype)


@pytest.mark.parametrize("geo", ["16/4", "4/16"])
def test_jax_pe_rounding_is_the_gap_at_full_range(geo):
    """At 16 frequencies on unit-range points (arguments up to ~2^17): the
    JAX kernel's PE (`_pe_forward`: its cos lanes sin(x + pi / 2) in f32)
    is off the float64 truth by up to half an ulp of the argument, the
    port's (`posenc`, torch.sin / cos) by less than 2^-22; the port's MLP on
    the JAX kernel's own PE gives the JAX kernel's output within F32_TOL.
    So what separates the two forwards there is the JAX PE's rounding."""
    nfx, nfd = GEOS[geo]
    jcfg, params, mlp, pts, dirs = _setup(128, nfx, nfd, scaled=False)
    mlp.requires_grad_(False)
    xd = _xd(pts, dirs)
    in_ch, d_ch = mlp.cfg.input_ch, mlp.cfg.input_ch_views
    C = jnp.asarray(jfused._pe_consts_np(nfx, nfd))
    xs, pe_j = (np.asarray(t) for t in jfused._pe_forward(jnp.asarray(xd.numpy()), C))
    pe_p = torch.cat([posenc(xd[:, 0:3], nfx), posenc(xd[:, 3:6], nfd)], 1).numpy()
    truth = np.where(np.asarray(C[fused.XD_CH + 2]) > 0,
                     np.sin(xs.astype(np.float64) + np.asarray(C[fused.XD_CH + 3])), xs)
    truth = truth[:, :in_ch + d_ch]
    half_ulp = np.spacing(np.abs(xs[:, :in_ch + d_ch]).astype(np.float32)) / 2
    assert np.abs(pe_p - truth).max() < 2.0 ** -22
    assert (np.abs(pe_j[:, :in_ch + d_ch] - truth) <= half_ulp + 2e-6).all()
    assert np.abs(pe_j[:, :in_ch + d_ch] - truth).max() > 1e-4  # the rounding shows here
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.eval_points_fused(params, jcfg, _jax_rc("float32", nfx, nfd),
                                                   jnp.asarray(pts), jnp.asarray(dirs),
                                                   tile=16)).reshape(-1, 4)
    pe_j = torch.from_numpy(pe_j.copy())
    got = fused.plain_mlp(mlp, pe_j[:, :in_ch], pe_j[:, in_ch:in_ch + d_ch], "float32")["out"]
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
