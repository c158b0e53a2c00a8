"""The port's fused MLP in bf16 at width 128 on the CPU, against the JAX package.

At width 128 the JAX package runs its Pallas kernels in bf16 too (its
`pad_params` pads the 64-wide views layer to 128 lanes); the port builds
its bf16 kernels (K1 bf16, the bf16 dgrad, the bf16 wgrad; K3 from them)
for that width as well, with the same padding, and its 'cuda' backend sends
such an MLP to the fused path by shape.  The kernels run only on the card
(chip_smoke.py's width128 phase holds them against their plain versions
there); here the plain versions and the kernels' arithmetic read from the
packed blobs, from numpy seeds:
  * `NerfMLPFn` (through `eval_points_fused`, bf16, stash and remat)
    against JAX's `eval_points_fused` in bf16 in interpret mode (tile 16,
    48 points): the raw output within test_torch_fused_mlp.py's BF16_TOL,
    the grads within `_assert_grads(..., "bfloat16")` (the width-256
    limits: each grad's max |error| within 3e-2 of its max, the median
    over the parameters of mean |error| / mean |value| within 1e-4);
  * one kernel-stage train step of the flagship (poster) shapes at
    netwidth = netwidth_fine = 128 through the 'cuda' backend in bf16
    stash (2 rays) against the JAX Trainer's `_loss_fn` on its Pallas
    kernel: each grad's max |error| within 5e-2 of its max and the median
    over the tensors of mean |error| / mean |value| within 1e-2
    (test_torch_train.py's bf16 limits at width 256), and the f32 path on
    the same step above that median bound (the control: the bound sees
    whether the bf16 rounding is on); both scene MLPs on the fused path,
    no launch.  The seeds are test_torch_width128.py's f32 step's (51, 52,
    53).  On 2 rays the max limit depends on the draws at both widths:
    over the seeds 41-48, 51, 61 and 71 at width 128 it held in 7 of 11
    (the others 0.054-0.25, where JAX's own f32 step is 0.17-0.49 from its
    bf16 one), and at width 256 seed 61 gives 0.098; the median stayed
    below 5.2e-3 in all 11, and the f32 control held in 10;
  * the bf16 forward blob at 128 undone by the index model of its layout
    (`sm90_mats`) gives back every weight, the zero-padded PE columns and
    the views layer's 64 padding rows zero; the kernel's arithmetic read
    from it (`_emulate_sm90`) reproduces `nerf_mlp_fwd_plain` in bf16
    (rtol 1e-4, atol 1e-5: the same roundings, the skip and views layers
    summed in another order) and the JAX kernel within BF16_TOL;
  * the transposed bf16 blob at 128 gives back each block exactly; the bf16
    wgrad's staged sums (64-point stages over the point splits of
    `wgrad_items` in bf16, each unit one tile in two 64-row halves) on the
    dgrad emulated from that blob reproduce `nerf_mlp_bwd_plain` (rtol
    1e-4, atol 1e-5) at 48 points (4 rays), a ragged 37 and 300 points in
    3 splits;
  * `wgrad_items` in bf16 at 128 takes every weight-grad entry once a
    split, a cluster's two blocks on the two 64-row halves of one tile.
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
from lushnerf_torch.models.renderer import RenderConfig
from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import nerf_mlp as fused
from lushnerf_torch.train import trainer
from tests.test_torch_convert import jax_params, params_like_init
from tests.test_torch_fused_mlp import BF16_TOL, _xd, sm90_mats
from tests.test_torch_fused_mlp_bwd import (_assert_grads, _bwd_blocks, _emulate_bwd_kernels,
                                            _jax_grads, _port_grads)
from tests.test_torch_fused_mlp_sm90 import CONFIGS, _emulate_sm90, _points
from tests.test_torch_fused_mlp_wgrad_bf16 import _w_numel, staged_wgrad
from tests.test_torch_lushnerf import FOCAL, H, W, _draws, _model
from tests.test_torch_train import (ALIAS_PREFIXES, BF16_MAX_REL, BF16_MEDIAN_MEAN_REL,
                                    _batch_both, _configs, _grads_by_name, _jax_step_fns)
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

WIDTH = 128
BF16 = "bfloat16"


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


def _torch_mlp(config, seed):
    in_ch, in_d = CONFIGS[config]
    return NeRFMLP(MLPConfig(depth=8, width=WIDTH, input_ch=in_ch, input_ch_views=in_d),
                   torch.Generator().manual_seed(seed), torch.device("cpu")).requires_grad_(False)


@pytest.mark.parametrize("mode", ["stash", "remat"])
def test_nerf_mlp_fn_matches_jax_fused_bf16(setup, mode):
    jcfg, params, pts, dirs = setup
    rc = RenderConfig(mlp_backend="cuda", mlp_compute_dtype=BF16, mlp_bwd=mode)
    mlp = _mlp(params)
    assert fused.supports(mlp.cfg, rc) and fused.kernel_covers(mlp.cfg, rc)
    with pltpu.force_tpu_interpret_mode():
        want = jfused.eval_points_fused(params, jcfg, JRenderConfig(mlp_compute_dtype=BF16,
                                                                    mlp_bwd=mode),
                                        jnp.asarray(pts), jnp.asarray(dirs), tile=16)
    with torch.no_grad():
        got = fused.eval_points_fused(mlp, mlp.cfg, rc, torch.from_numpy(pts),
                                      torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)
    want_g = _jax_grads(params, jcfg, pts, dirs, BF16, mode)
    fused.launches = fused.launches_bwd_stash = fused.launches_bwd_remat = 0
    got_g = _port_grads(mlp, pts, dirs, BF16, mode)
    assert fused.launches == fused.launches_bwd_stash == fused.launches_bwd_remat == 0
    assert build._LIBS == {}  # a CPU tensor never builds or launches a kernel
    _assert_grads(got_g, want_g, BF16)


def test_train_step_width128_cuda_bf16_matches_pallas(monkeypatch):
    """The flagship (poster) shapes at netwidth = netwidth_fine = 128 in
    bf16 with the stash backward: one kernel-stage step's grads against
    the JAX Trainer's on its Pallas kernel (interpret mode); both scene
    MLPs go through `eval_points_fused`, whose plain versions stand in for
    the kernels on the CPU.  The same step in f32 misses the median bound."""
    extra = dict(netwidth=WIDTH, netwidth_fine=WIDTH, mlp_bwd="stash")
    cfg, lc, jcfg, jlc = _configs(tiny=False, backend="cuda", dtype=BF16, **extra)
    _, lc32, _, _ = _configs(tiny=False, backend="cuda", dtype="float32", **extra)
    assert (lc.mlp_cfg.width, lc.mlp_cfg_fine.width, lc.render.mlp_bwd) == (WIDTH, WIDTH, "stash")
    assert fused.kernel_covers(lc.mlp_cfg, lc.render) and fused.kernel_covers(lc.mlp_cfg_fine,
                                                                               lc.render)
    params = jax_params(jlc, seed=51)
    batch, jbatch = _batch_both(2, seed=52)
    rnd = _draws(lc, 2 * lc.rbk.num_rays_out, seed=53)
    vg, _ = _jax_step_fns(jlc, jcfg, "kernel", {k: jnp.asarray(v) for k, v in rnd.items()},
                          monkeypatch)
    with pltpu.force_tpu_interpret_mode():
        (_, _), jgrads = jax.jit(vg)(params, jbatch)
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()}
    calls = []
    real = fused.eval_points_fused
    monkeypatch.setattr(fused, "eval_points_fused",
                        lambda *a, **k: calls.append((a[1].width, a[2].mlp_compute_dtype))
                        or real(*a, **k))
    got = {}
    for name, c in (("bf16", lc), ("f32", lc32)):
        calls.clear()
        fused.launches = fused.launches_bwd_stash = 0
        model = _model(c, params)
        loss, _ = trainer.loss_fn(model, c, H, W, FOCAL, batch, "kernel",
                                  rand_override={k: torch.from_numpy(v) for k, v in rnd.items()})
        loss.backward()
        assert calls == [(WIDTH, c.render.mlp_compute_dtype)] * 2
        assert fused.launches == fused.launches_bwd_stash == 0
        got[name] = _grads_by_name(model)
    # every parameter once: the other names of `want` are aliases of the shared RBK
    assert set(got["bf16"]) <= set(want)
    assert all(k.startswith(ALIAS_PREFIXES) for k in set(want) - set(got["bf16"]))
    median = {}
    for name, grads in got.items():
        rel = {n: np.abs(g - want[n]).mean() / max(np.abs(want[n]).mean(), 1e-30)
               for n, g in grads.items()}
        median[name] = float(np.median(list(rel.values())))
    for n, g in got["bf16"].items():
        err = np.abs(g - want[n]).max() / max(np.abs(want[n]).max(), 1e-30)
        assert err <= BF16_MAX_REL, (n, err)
    assert median["bf16"] <= BF16_MEDIAN_MEAN_REL, median
    assert median["f32"] > BF16_MEDIAN_MEAN_REL, median  # the bound sees the bf16 rounding


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bf16_blob_gives_back_every_weight_at_128(config):
    """Each of the ten matrices read back by index is its weight in bf16
    with K in the order the kernel reads it, zero in every PE column the
    layer does not read and in the views layer's 64 padding rows; one
    [128][64] piece a chunk, padded to an even count."""
    mlp = _torch_mlp(config, 0)
    in_ch, in_d = CONFIGS[config]
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    nx, d0, nd = fused.pe_geometry(mlp.cfg)[3:]
    w, _ = fused.pack_params(mlp, BF16)
    n = 2 * nx + 16 + 2 + nd  # the kernel's pieces a tile: W0 nx, W1..W4 8, W5 2 + nx, 6, Wv 2 + nd
    assert w.dtype == torch.bfloat16 and w.numel() // (128 * 64) == n + n % 2
    got = sm90_mats(w, kx, kd, WIDTH)
    r = lambda t: t.bfloat16().float()  # noqa: E731
    pts = [lin.weight for lin in mlp.pts_linears]
    wv = mlp.views_linears[0].weight

    def placed(m, n_chunks, col0, rows=None):
        out = torch.zeros(rows or m.shape[0], 64 * n_chunks)
        out[:m.shape[0], col0:col0 + m.shape[1]] = m
        return out

    want = [placed(pts[0], nx, 0)] + pts[1:5] + [
        torch.cat([pts[5][:, in_ch:], placed(pts[5][:, :in_ch], nx, 0)], 1)] + pts[6:8] + [
        mlp.feature_linear.weight,
        torch.cat([placed(wv[:, :WIDTH], 2, 0, 128), placed(wv[:, WIDTH:], nd, kx - 64 * d0, 128)],
                  1)]
    assert [tuple(m.shape) for m in got] == [tuple(m.shape) for m in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), r(b).numpy())
    assert not got[9][64:].any()  # the views layer's padding rows


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bf16_emulation_reproduces_plain_at_128(config):
    in_ch, in_d = CONFIGS[config]
    nfx, nfd = (in_ch - 3) // 6, (in_d - 3) // 6
    mlp = _torch_mlp(config, 1)
    xd = _points(96, seed=2)
    got = _emulate_sm90(mlp, xd, nfx, nfd)
    want = fused.nerf_mlp_fwd_plain(mlp, xd, BF16, nfx, nfd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_bf16_emulation_matches_jax_kernel_at_128(setup):
    jcfg, params, pts, dirs = setup
    with pltpu.force_tpu_interpret_mode():
        want = jfused.eval_points_fused(params, jcfg, JRenderConfig(mlp_compute_dtype=BF16),
                                        jnp.asarray(pts), jnp.asarray(dirs), tile=16)
    got = _emulate_sm90(_mlp(params).requires_grad_(False), _xd(pts, dirs), 10, 4)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), np.asarray(want), **BF16_TOL)


def test_bf16_bwd_blob_gives_back_the_transposed_weights_at_128(setup):
    """The dgrad's bf16 blob at 128 read through the index model: each block
    transposed ([in][out], PE rows past the encoding zero, the views
    blocks' 64 padding lanes zero) in bf16, exactly."""
    _, params, _, _ = setup
    mlp = _mlp(params).requires_grad_(False)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    in_ch = mlp.cfg.input_ch
    pts = [lin.weight for lin in mlp.pts_linears]
    wv = torch.nn.functional.pad(mlp.views_linears[0].weight, (0, 0, 0, 64))  # 128 lanes

    def padded_t(w, k):
        return torch.cat([w.T, torch.zeros(k - w.shape[1], w.shape[0])], 0)

    want = [padded_t(pts[0], kx)] + [pts[i].T for i in range(1, 5)] + [
        padded_t(pts[5][:, :in_ch], kx), pts[5][:, in_ch:].T, pts[6].T, pts[7].T,
        mlp.feature_linear.weight.T, wv[:, :WIDTH].T, padded_t(wv[:, WIDTH:], kd)]
    got = _bwd_blocks(mlp, BF16)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.bfloat16().float().numpy())
    assert not got[10][:, 64:].any() and not got[11][:, 64:].any()


def _bwd_inputs(setup, P):
    """The setup's MLP on its first P points (or, past its 48, P points of
    numpy seed 11 on P // 100 rays), the bf16 stash and g ~ N(0, 1)."""
    _, params, pts, dirs = setup
    if P > pts.shape[0] * pts.shape[1]:
        rng = np.random.default_rng(11)
        pts = rng.standard_normal((P // 100, 100, 3)).astype(np.float32)
        dirs = rng.standard_normal((P // 100, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mlp = _mlp(params).requires_grad_(False)
    xd = _xd(pts, dirs)[:P].contiguous()
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((P, 4)).astype(np.float32))
    _, acts = fused.nerf_mlp_fwd_plain(mlp, xd, BF16, with_acts=True)
    return mlp, xd, g, acts


@pytest.mark.parametrize("P,n_splits", [(48, None), (37, None), (300, 3)],
                         ids=["rays", "ragged", "splits"])
def test_staged_wgrad_reproduces_plain_bf16_at_128(setup, P, n_splits):
    mlp, xd, g, acts = _bwd_inputs(setup, P)
    assert acts.shape == (P, fused.layout(WIDTH).acts_ld) and acts.dtype == torch.bfloat16
    n = n_splits or fused.wgrad_splits(P, BF16)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    _, _, got = _emulate_bwd_kernels(mlp, xd, g, acts, BF16,
                                     wgrad=staged_wgrad(n, kx, kd, WIDTH))
    _, want = fused.nerf_mlp_bwd_plain(mlp, xd, g, BF16, acts=acts)
    assert [t.shape for t in got] == [p.shape for p in mlp.parameters()]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_splits", [1, 3, fused.WGRAD_BF16_SPLITS])
def test_wgrad_items_bf16_at_128(n_splits):
    kx, kd = 64, 32
    items = fused.wgrad_items(n_splits, kx, kd, BF16, WIDTH)
    assert len(items) == 2 * 12 * n_splits  # 9 wide and 3 narrow units a split, in halves
    seen = np.zeros((n_splits, _w_numel(kx, kd, WIDTH)), np.int8)
    for _, s, rows, I, off, ldw, _, _, _ in items:
        idx = off + np.arange(rows)[:, None] * ldw + np.arange(I)[None, :]
        seen[s, idx] += 1
    assert (seen == 1).all()
    wide = [it[3] == WIDTH for it in items]
    assert wide == sorted(wide, reverse=True) and sum(wide) == 2 * 9 * n_splits
    for a, b in zip(items[0::2], items[1::2]):  # a cluster's two blocks: one tile's halves
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2] == 64 and a[3] == b[3]
        assert b[4] == a[4] + 64 * a[5] and b[6] == a[6] + 64 and a[7:] == b[7:]
    # the tiles one after another in each split: the wide ones 0..8, then 9..11
    assert [it[0] for it in items[0::2]] == [t for s in range(n_splits) for t in range(9)] + [
        t for s in range(n_splits) for t in range(9, 12)]
