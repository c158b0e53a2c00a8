"""The port's fused MLP at width 128 on the CPU, against the JAX package.

Width 128 is the one width besides 256 where the JAX package runs its
Pallas kernels (its `pad_params` pads the 64-wide views layer to 128
lanes); the port builds its f32 kernels for it (csrc/, -DNERF_MLP_WIDTH=128)
with the same padding.  The kernels run only on the card (chip_smoke.py's
width128 phase holds them against their plain versions there); here the
plain versions, the packed blobs and the scale units, from numpy seeds:
  * `NerfMLPFn` (through `eval_points_fused`, f32, stash and remat) against
    JAX's `eval_points_fused` f32 in interpret mode (tile 16, 48 points):
    the raw output within rtol 1e-4 / atol 1e-5, the grads of the points,
    the directions and all 24 parameters each within 2e-5 of its max
    magnitude (test_torch_fused_mlp_bwd.py's f32 limit at 256);
  * one kernel-stage train step of the flagship (poster) shapes at width
    128 through the 'cuda' backend in f32 remat (the shipped configs'
    path; 2 rays) against the JAX Trainer's `_loss_fn` on its Pallas
    kernel: the loss within rtol 1e-5, the median over the tensors of mean
    |error| / mean |value| within 1e-4 (test_torch_train.py's f32 limit;
    measured 2.5e-6) and each grad's max |error| within 1e-2 of its max
    (measured 5.0e-3: the PE's 2^9 band carries f32 rounding through the
    importance samples; the two packages' plain f32 paths, torch against
    JAX's 'xla', differ by 5.1e-3 and 2.3e-6 on the same step), and both
    scene MLPs on the fused path with no launch;
  * the blobs at 128: the f32 blob (`pack_params`) holds every bias and
    head at `layout(128)`'s offsets, the views layer's padding lanes 0;
    the split backward read from `pack_params_bwd`'s blob as the kernels
    read it (tests/test_torch_fused_mlp_bwd_split.py's `emulate`, the
    split wgrad over 5 point splits) reproduces `nerf_mlp_bwd_plain`
    within 1e-4 of each grad's max (chip_smoke.py's f32 BWD_TOL); the
    wgrad's work items (`wgrad_items`) cover every weight-grad entry once a
    split, 9 wide tiles then 3 narrow ones; `chunk_wgrad_splits` fills
    whole waves of 132 SMs;
  * `dz_scale_units` and `stash_scale_units` at 128, index by index;
  * widths 384 and 512: JAX's `supports` accepts them but its `pad_params`
    raises (the views layer wider than its 128 lanes), while the port's
    'cuda' backend sends them to the plain torch path by shape, equal to
    the torch backend bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lushnerf_tpu.models.mlp import MLPConfig as JMLPConfig
from lushnerf_tpu.models.mlp import init_nerf_mlp
from lushnerf_tpu.models.renderer import RenderConfig as JRenderConfig
from lushnerf_tpu.ops.fused import nerf_mlp as jfused
from lushnerf_torch.convert import mlp_state_from_jax, params_from_jax
from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.models.renderer import RenderConfig, eval_points
from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import nerf_mlp as fused
from lushnerf_torch.train import trainer
from tests.test_torch_convert import jax_params, params_like_init
from tests.test_torch_fused_mlp import F32_TOL
from tests.test_torch_fused_mlp_bwd import (_assert_grads, _jax_grads, _median_mean_rel,
                                            _port_grads, _rel_err)
from tests.test_torch_fused_mlp_bwd_split import _split, emulate, split_wgrad
from tests.test_torch_lushnerf import FOCAL, H, W, _draws, _model
from tests.test_torch_train import (ALIAS_PREFIXES, GRAD_REL, _batch_both, _configs,
                                    _grads_by_name, _jax_step_fns)
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

WIDTH = 128
BWD_LIMIT = 1e-4  # max |error| / max |value| of each grad (chip_smoke.py's f32 BWD_TOL)
POSTER_MAX_REL = 1e-2  # the poster-shaped step's max |error| / max |value| of each grad


@pytest.fixture(scope="module")
def setup():
    jcfg = JMLPConfig(depth=8, width=WIDTH, input_ch=63, input_ch_views=27)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg), seed=9)
    rng = np.random.default_rng(11)
    R, S = 4, 12
    pts = rng.standard_normal((R, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jcfg, params, pts, dirs


def _mlp(params):
    mlp = NeRFMLP(MLPConfig(width=WIDTH), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(params))
    return mlp


@pytest.mark.parametrize("mode", ["stash", "remat"])
def test_nerf_mlp_fn_matches_jax_fused_f32(setup, mode):
    jcfg, params, pts, dirs = setup
    rc = RenderConfig(mlp_backend="cuda", mlp_compute_dtype="float32", mlp_bwd=mode)
    mlp = _mlp(params)
    assert fused.supports(mlp.cfg, rc) and fused.kernel_covers(mlp.cfg, rc)
    with pltpu.force_tpu_interpret_mode():
        want = jfused.eval_points_fused(params, jcfg, JRenderConfig(mlp_compute_dtype="float32",
                                                                    mlp_bwd=mode),
                                        jnp.asarray(pts), jnp.asarray(dirs), tile=16)
    with torch.no_grad():
        got = fused.eval_points_fused(mlp, mlp.cfg, rc, torch.from_numpy(pts),
                                      torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    want_g = _jax_grads(params, jcfg, pts, dirs, "float32", mode)
    fused.launches = fused.launches_bwd_stash = fused.launches_bwd_remat = 0
    got_g = _port_grads(mlp, pts, dirs, "float32", mode)
    assert fused.launches == fused.launches_bwd_stash == fused.launches_bwd_remat == 0
    assert build._LIBS == {}  # a CPU tensor never builds or launches a kernel
    _assert_grads(got_g, want_g, "float32")


def test_train_step_width128_cuda_f32_matches_pallas(monkeypatch):
    """The flagship (poster) shapes at netwidth = netwidth_fine = 128 on the
    shipped configs' path (fused, f32, remat): one kernel-stage step's loss
    and grads against the JAX Trainer's on its Pallas kernel (interpret
    mode); both scene MLPs go through `eval_points_fused`, whose plain
    versions stand in for the kernels on the CPU."""
    extra = dict(netwidth=WIDTH, netwidth_fine=WIDTH, mlp_bwd="remat")
    cfg, lc, jcfg, jlc = _configs(tiny=False, backend="cuda", dtype="float32", **extra)
    assert (lc.mlp_cfg.width, lc.mlp_cfg_fine.width, lc.render.mlp_bwd) == (WIDTH, WIDTH, "remat")
    assert fused.kernel_covers(lc.mlp_cfg_fine, lc.render)
    params = jax_params(jlc, seed=51)
    batch, jbatch = _batch_both(2, seed=52)
    rnd = _draws(lc, 2 * lc.rbk.num_rays_out, seed=53)
    vg, _ = _jax_step_fns(jlc, jcfg, "kernel", {k: jnp.asarray(v) for k, v in rnd.items()},
                          monkeypatch)
    with pltpu.force_tpu_interpret_mode():
        (jloss, _), jgrads = jax.jit(vg)(params, jbatch)
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()}
    calls = []
    real = fused.eval_points_fused
    monkeypatch.setattr(fused, "eval_points_fused", lambda *a, **k: calls.append(a[1].width)
                        or real(*a, **k))
    fused.launches = fused.launches_bwd_remat = 0
    model = _model(lc, params)
    loss, _ = trainer.loss_fn(model, lc, H, W, FOCAL, batch, "kernel",
                              rand_override={k: torch.from_numpy(v) for k, v in rnd.items()})
    loss.backward()
    assert calls == [WIDTH, WIDTH] and fused.launches == fused.launches_bwd_remat == 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = _grads_by_name(model)
    # every parameter once: the other names of `want` are aliases of the shared RBK
    assert set(got) <= set(want)
    assert all(k.startswith(ALIAS_PREFIXES) for k in set(want) - set(got))
    want = {k: want[k] for k in got}
    for name, g in got.items():
        assert _rel_err(g, want[name]) <= POSTER_MAX_REL, (name, _rel_err(g, want[name]))
    assert _median_mean_rel(got, want) <= GRAD_REL, _median_mean_rel(got, want)


def test_f32_blob_layout_at_128(setup):
    _, params, _, _ = setup
    mlp = _mlp(params).requires_grad_(False)
    L = fused.layout(WIDTH)
    assert (L.acts_ld, L.fp_numel) == (9 * 128 + 128, 8 * 128 + 128 + 128 + 8 + 128 + 3 * 128)
    w, fp = fused.pack_params(mlp, "float32")
    assert fp.numel() == L.fp_numel and w.numel() % (fused.SPLIT_RING * fused.FWD_PIECE) == 0
    assert torch.equal(fp[:L.fp_bf], torch.cat([lin.bias for lin in mlp.pts_linears]))
    assert torch.equal(fp[L.fp_bf:L.fp_bv], mlp.feature_linear.bias)
    assert torch.equal(fp[L.fp_bv:L.fp_bv + 64], mlp.views_linears[0].bias)
    assert not fp[L.fp_bv + 64:L.fp_ba].any()  # the views layer's padding lanes
    assert fp[L.fp_ba] == mlp.alpha_linear.bias[0]
    assert torch.equal(fp[L.fp_br:L.fp_br + 3], mlp.rgb_linear.bias)
    assert torch.equal(fp[L.fp_wa:L.fp_wr], mlp.alpha_linear.weight[0])
    wr = fp[L.fp_wr:].reshape(3, 128)
    assert torch.equal(wr[:, :64], mlp.rgb_linear.weight) and not wr[:, 64:].any()
    mats = fused.bwd_mats(mlp)
    assert mats[10].shape == (128, 128) and not mats[10][:, 64:].any()  # Wvf^T
    assert mats[11].shape == (32, 128) and not mats[11][:, 64:].any()  # Wvd^T


@pytest.mark.parametrize("cot", ["normal", "shipped"])
def test_split_backward_reproduces_plain_at_128(setup, cot):
    """The f32 dgrad's and wgrad's split arithmetic at width 128, read from
    the packed transposed blob, against the plain backward at 300 points
    (three dgrad tiles, the last ragged) in 5 point splits, at g ~ N(0, 1)
    and at a cotangent shaped like the shipped step's."""
    _, params, _, _ = setup
    mlp = _mlp(params).requires_grad_(False)
    rng = np.random.default_rng(21)
    P = 300
    xd = torch.zeros(P, 8)
    xd[:, :3] = torch.from_numpy(rng.uniform(-1, 1, (P, 3)).astype(np.float32))
    d = rng.standard_normal((P, 3)).astype(np.float32)
    xd[:, 3:6] = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    if cot == "normal":
        g = rng.standard_normal((P, 4))
    else:
        g = (np.exp2(rng.uniform(-28, -17, (P, 4))) * rng.choice([-1, 1], (P, 4))
             * (rng.random((P, 1)) < 0.5))
    g = torch.from_numpy(g.astype(np.float32))
    _, acts = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    assert acts.shape == (P, fused.layout(WIDTH).acts_ld)
    d_xd, _, got = emulate(mlp, xd, g, acts, _split(mlp), wgrad=split_wgrad(5))
    want_xd, want = fused.nerf_mlp_bwd_plain(mlp, xd, g, "float32", acts=acts)
    assert [t.shape for t in got] == [p.shape for p in mlp.parameters()]
    for i, (a, b) in enumerate(zip([d_xd] + got, [want_xd] + want)):
        err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        assert err <= BWD_LIMIT, (i, err)


def test_wgrad_items_at_128():
    kx, kd = 64, 32
    n_splits = 3
    items = fused.wgrad_items(n_splits, kx, kd, "float32", WIDTH)
    assert len(items) == n_splits * fused.wgrad_tiles(WIDTH) == 36
    wn = WIDTH * kx + 7 * WIDTH * WIDTH + WIDTH * (kx + WIDTH) + 128 * (WIDTH + kd)
    for s in range(n_splits):
        cover = torch.zeros(wn, dtype=torch.int32)
        for t, split, rows, I, off, ldw, zc, pe, ac in items:
            if split != s:
                continue
            assert rows == fused.WGRAD_TILE_ROWS
            idx = torch.arange(rows)[:, None] * ldw + torch.arange(I)[None] + off
            cover[idx.flatten()] += 1
        assert bool((cover == 1).all()), s
    # split by split, the 9 wide tiles (I = 128), then the 3 narrow ones
    wide = [it for it in items if it[3] == WIDTH]
    assert items[:len(wide)] == wide and len(wide) == 9 * n_splits
    assert [it[1] for it in wide] == [s for s in range(n_splits) for _ in range(9)]
    # the views blocks read d_hv's 128 lanes at column 9 W of dz
    assert {it[6] for it in items if it[0] in (8, 11)} == {9 * WIDTH}
    # over several chunks the f32 wgrad's items fill whole waves of an H100
    for n in (65_536, 131_072, 327_680 - 4 * 65_536):
        splits = fused.chunk_wgrad_splits(n, "float32", 5, 132, WIDTH)
        assert splits * fused.wgrad_tiles(WIDTH) % 132 == 0 and n // splits >= 4096, (n, splits)


def test_scale_units_by_index_at_128(setup):
    """dz_scale_units and stash_scale_units on [P, acts_ld(128)] rows: the
    blocks are 128 columns (d_hv's 128 lanes), entry (t, b, w) the largest
    unit over the rows p of tile t with p % 3 == w (dz; p within the tile)
    or rows 16 w .. 16 w + 15 (stash)."""
    _, params, _, _ = setup
    mlp = _mlp(params).requires_grad_(False)
    rng = np.random.default_rng(23)
    P = 300
    xd = torch.zeros(P, 8)
    xd[:, :3] = torch.from_numpy(rng.uniform(-1, 1, (P, 3)).astype(np.float32))
    xd[:, 3:6] = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((P, 3)).astype(np.float32)), dim=-1)
    _, acts = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    dz = torch.from_numpy(rng.standard_normal(acts.shape).astype(np.float32)
                          * np.exp2(rng.integers(-40, 10, (P, 1))).astype(np.float32))
    dz[5] = 0  # a zero row
    T = fused.DGRAD_TILE
    zs = fused.dz_scale_units(dz)
    assert zs.shape == (3, fused.ZS_BLOCKS, fused.ZS_WARPS)
    for b in range(fused.ZS_BLOCKS):
        m = dz[:, b * WIDTH:(b + 1) * WIDTH].abs().amax(1)
        for t in range(3):
            for w in range(fused.ZS_WARPS):
                rows = [p for p in range(t * T, min(P, t * T + T))
                        if (p - t * T) % 3 == w and m[p] > 0]
                want = max((2.0 ** -int(15 - torch.frexp(m[p]).exponent) for p in rows),
                           default=0.0)
                assert zs[t, b, w].item() == want, (b, t, w)
    units = fused.stash_scale_units(acts * 1e5)  # rows past 2^15: scaled
    assert units.shape == (3, fused.UNIT_BLOCKS, fused.UNIT_WARPS) and bool((units > 1).any())
    for b in range(fused.UNIT_BLOCKS):
        k = fused.row_scale_exponents((acts * 1e5)[:, b * WIDTH:(b + 1) * WIDTH].abs().amax(1))
        for t in range(3):
            for w in range(fused.UNIT_WARPS):
                rows = range(t * T + 16 * w, min(P, t * T + 16 * (w + 1)))
                want = max((2.0 ** int(k[p]) for p in rows), default=1.0)
                assert units[t, b, w].item() == want, (b, t, w)


@pytest.mark.parametrize("width", [384, 512])
def test_wider_mlps_jax_pad_params_raises_port_routes_to_torch(width, monkeypatch):
    """A difference of the JAX package, pinned: its `supports` accepts
    widths 384 and 512 (a multiple of 128), but `pad_params` pads the views
    layer, width / 2 wide, to 128 lanes, which is negative there, and
    raises.  The port's `supports` matches JAX's, and its 'cuda' backend
    sends the MLP to the plain torch path by shape (no kernel is built for
    it), equal to the torch backend bit for bit."""
    jcfg = JMLPConfig(depth=8, width=width, input_ch=63, input_ch_views=27)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg), seed=3)
    assert jfused.supports(jcfg, JRenderConfig())
    with pytest.raises(ValueError):
        jfused.pad_params(params, width)
    jfused.pad_params(params_like_init(lambda k: init_nerf_mlp(k, JMLPConfig(width=WIDTH)),
                                       seed=3), WIDTH)  # 128 pads
    cfg = MLPConfig(width=width)
    rc = RenderConfig(mlp_backend="cuda", mlp_compute_dtype="float32")
    assert fused.supports(cfg, rc) and not fused.kernel_covers(cfg, rc)
    mlp = NeRFMLP(cfg, torch.Generator().manual_seed(4), torch.device("cpu")).requires_grad_(False)
    calls = []
    monkeypatch.setattr(fused, "eval_points_fused", lambda *a, **k: calls.append(a))
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((2, 3)).astype(np.float32)), dim=-1)
    got = eval_points(mlp, cfg, rc, pts, dirs)
    want = eval_points(mlp, cfg, RenderConfig(mlp_backend="torch"), pts, dirs)
    assert calls == [] and torch.equal(got, want)
    with pytest.raises(ValueError, match="width 256 and 128"):
        fused.check_kernel_family(cfg, "float32", 10, 4)
