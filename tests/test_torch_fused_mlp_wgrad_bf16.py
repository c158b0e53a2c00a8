"""The bf16 wgrad kernel's geometry and summation (lushnerf_torch/csrc/
nerf_mlp_bwd.cu, namespace bf16w) on the CPU, where no kernel runs
(chip_smoke.py holds the kernel against the plain backward on the card,
and the wrapper checks `wgrad_items` against the CUDA source's own table
when it loads the library):
  * the split count and points a split (`wgrad_splits`,
    `wgrad_pts_per_split`): every point falls in exactly one split, none is
    empty, every split but the last is a whole number of the kernel's
    64-point stages (the f32 wgrad's 32-point ones alike);
  * its work (`wgrad_items`): every row of every (tile, split) is taken
    once, in the kernel's order -- a split's units one after another, the
    wide ones of every split first, the two blocks of a cluster on the two
    o-halves of one weight block (or the two 64-row halves of Wvf's and
    Wvd's 128 rows) with the same A columns; the tiles cover
    `chip_smoke.wgrad_jobs`'s 12 blocks exactly;
  * its summation emulated (each work entry's points in 64-point stages,
    bf16 operands into an f32 accumulator, partials summed in split order)
    on the bf16 dgrad emulated from the packed blob reproduces
    `nerf_mlp_bwd_plain` within rtol 1e-4 / atol 1e-5 (the same bf16
    products summed in another order), at 64 points, a ragged 37 and 300
    points in 3 splits with a ragged last stage; and the JAX Pallas
    kernel's bf16 stash backward (jax.grad under jax.jit, interpret mode,
    at g ~ N(0, 1)) at 64 and 37 points: the median over tensors of mean
    error over mean value <= 1e-4 (test_torch_fused_mlp_bwd.py's bound;
    measured 4e-5 to 5e-5), and each tensor's max error at most 1e-4 of its
    max value above that of `nerf_mlp_bwd_plain` on the same inputs.  The
    plain backward's own max error reaches 0.05 to 0.17 of W2's grad there:
    the port's bf16 forward and the JAX kernel's sum in another order and
    disagree in a few relu masks (ROADMAP, faults, item 3), which moves
    whole rows of a weight grad; the staged wgrad adds nothing to that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from lushnerf_torch.convert import mlp_state_from_jax
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_fused_mlp import _xd
from tests.test_torch_fused_mlp_bwd import setup  # noqa: F401  (the fixture)
from tests.test_torch_fused_mlp_bwd import (BF16_MEDIAN_MEAN_REL, _emulate_bwd_kernels,
                                            _median_mean_rel, _mlp)
from lushnerf_tpu.models.renderer import RenderConfig as JRenderConfig
from lushnerf_tpu.ops.fused import nerf_mlp as jfused
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

BF16 = "bfloat16"
KS = fused.WGRAD_STAGE[BF16]  # points a stage of the bf16 wgrad
WD, WH = 256, 128


def _w_numel(kx, kd, wd=WD):
    return wd * kx + 7 * wd * wd + wd * (kx + wd) + WH * (wd + kd)


def _splits(P, n, dtype):
    per = fused.wgrad_pts_per_split(P, n, dtype)
    return per, [(k0, min(P, k0 + per)) for k0 in range(0, n * per, per)]


@pytest.mark.parametrize("P", [1, 37, 64, 65, 4_097, 65_573, 262_181, 327_680, 655_360, 983_040])
def test_splits_take_every_point_once_in_whole_stages(P):
    for dtype in fused.COMPUTE_DTYPES:
        n = fused.wgrad_splits(P, dtype)
        per, splits = _splits(P, n, dtype)
        assert 1 <= n <= (fused.WGRAD_BF16_SPLITS if dtype == BF16 else fused.WGRAD_F32_SPLITS)
        assert per % fused.WGRAD_STAGE[dtype] == 0
        assert all(k1 > k0 for k0, k1 in splits), "an empty split"
        assert splits[0][0] == 0 and splits[-1][1] == P
        assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
        assert all((k1 - k0) % fused.WGRAD_STAGE[dtype] == 0 for k0, k1 in splits[:-1])
    # the count chosen for the flagship's point counts
    if P >= fused.WGRAD_BF16_SPLITS * fused.WGRAD_BF16_SPLIT_POINTS:
        assert fused.wgrad_splits(P, BF16) == fused.WGRAD_BF16_SPLITS


@pytest.mark.parametrize("dtype,n_splits", [(BF16, 1), (BF16, 3), (BF16, fused.WGRAD_BF16_SPLITS),
                                            ("float32", 3)])
def test_items_take_every_row_of_every_tile_and_split_once(dtype, n_splits):
    kx, kd = 64, 32
    items = fused.wgrad_items(n_splits, kx, kd, dtype)
    seen = np.zeros((n_splits, _w_numel(kx, kd)), np.int8)
    for _, s, rows, I, off, ldw, _, _, _ in items:
        idx = off + np.arange(rows)[:, None] * ldw + np.arange(I)[None, :]
        seen[s, idx] += 1
    assert (seen == 1).all()
    wide = [it[3] == WD for it in items]
    assert wide == sorted(wide, reverse=True)  # every split's wide work first
    for group in (True, False):  # a split's work one after another, in split order
        splits = [it[1] for it, w in zip(items, wide) if w == group]
        assert splits == sorted(splits)
    if dtype == BF16:  # a cluster's two blocks: one unit, the same A columns
        assert len(items) == 2 * 12 * n_splits  # 9 wide and 3 narrow units a split
        for a, b in zip(items[0::2], items[1::2]):
            assert a[1] == b[1] and a[3] == b[3] and a[5] == b[5] and a[7:] == b[7:]
            assert b[4] == a[4] + a[2] * a[5] and b[6] == a[6] + a[2]  # the next rows of the block
            assert (a[2], a[0] + 1) == (128, b[0]) or (a[2], a[0]) == (64, b[0])
    else:
        assert len(items) == 22 * n_splits


@pytest.mark.parametrize("kx,kd", [(64, 32), (96, 32), (32, 32)])
def test_tiles_cover_chip_smoke_wgrad_jobs(kx, kd):
    tiles = fused.wgrad_items(1, kx, kd)
    rows_of = {}
    for _, _, rows, I, _, _, zc, from_pe, ac in tiles:
        job = next(j for j in chip_smoke.wgrad_jobs(kx, kd)
                   if j[0] <= zc < j[0] + j[1] and j[2:] == (bool(from_pe), ac, I))
        rows_of.setdefault(job, []).extend(range(zc, zc + rows))
    assert sorted(rows_of) == sorted(chip_smoke.wgrad_jobs(kx, kd))
    for (zc, O, _, _, _), rows in rows_of.items():
        assert sorted(rows) == list(range(zc, zc + O))


def staged_wgrad(n_splits, kx, kd, width=WD):
    """The bf16 wgrad kernel's sums on the dgrad's dz [P, acts_ld], the stash
    and the PE (bf16 values, in float) at the MLP width `width`: for each
    work entry, its split's points in stages of 64 (zero rows past P), each
    stage's dZ^T A added to an f32 accumulator; then the partials summed in
    split order."""
    def wgrad(dz, acts, pe):
        P, numel = dz.shape[0], _w_numel(kx, kd, width)
        per = fused.wgrad_pts_per_split(P, n_splits, BF16)
        pad = lambda t: torch.cat([t, t.new_zeros(KS, t.shape[1])])  # noqa: E731
        dz, acts, pe = pad(dz), pad(acts), pad(pe)
        part = torch.zeros(n_splits * numel)
        for _, s, rows, I, off, ldw, zc, from_pe, ac in fused.wgrad_items(n_splits, kx, kd, BF16,
                                                                          width):
            src = pe if from_pe else acts
            acc = torch.zeros(rows, I)
            for p0 in range(s * per, min(P, (s + 1) * per), KS):
                acc += dz[p0:p0 + KS, zc:zc + rows].T @ src[p0:p0 + KS, ac:ac + I]
            torch.as_strided(part, (rows, I), (ldw, 1), s * numel + off).copy_(acc)
        part = part.reshape(n_splits, numel)
        dw = torch.zeros(numel)
        for s in range(n_splits):
            dw += part[s]
        return dw
    return wgrad


def _inputs(setup, P):
    """The setup's MLP on its first P points (or, past its 64, P points of
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


@pytest.mark.parametrize("P,n_splits", [(64, None), (37, None), (300, 3)],
                         ids=["tile", "ragged", "splits"])
def test_staged_wgrad_reproduces_plain_bf16(setup, P, n_splits):
    mlp, xd, g, acts = _inputs(setup, P)
    n = n_splits or fused.wgrad_splits(P, BF16)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    _, _, got = _emulate_bwd_kernels(mlp, xd, g, acts, BF16, wgrad=staged_wgrad(n, kx, kd))
    _, want = fused.nerf_mlp_bwd_plain(mlp, xd, g, BF16, acts=acts)
    assert [t.shape for t in got] == [p.shape for p in mlp.parameters()]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("P", [64, 37], ids=["tile", "ragged"])
def test_staged_wgrad_reproduces_jax_kernel_bf16(setup, P):
    jcfg, params, pts, dirs = setup
    if P < pts.shape[0] * pts.shape[1]:  # one ray of P samples
        pts, dirs = pts.reshape(1, -1, 3)[:, :P], dirs[:1]
    R, S = pts.shape[:2]
    G = np.random.default_rng(13).standard_normal((R, S, 4)).astype(np.float32)
    rc = JRenderConfig(mlp_compute_dtype=BF16, mlp_bwd="stash")

    @jax.jit
    def grads(p):  # the cotangent of raw in sum(raw * G) is G
        return jax.grad(lambda q: jnp.sum(jfused.eval_points_fused(
            q, jcfg, rc, jnp.asarray(pts), jnp.asarray(dirs), tile=16) * G))(p)

    with pltpu.force_tpu_interpret_mode():
        gp = jax.tree.map(np.asarray, grads(params))
    want = {k: v.numpy() for k, v in mlp_state_from_jax(gp).items()}
    mlp = _mlp(params).requires_grad_(False)
    xd = _xd(pts, dirs)
    g = torch.from_numpy(G.reshape(R * S, 4))
    _, acts = fused.nerf_mlp_fwd_plain(mlp, xd, BF16, with_acts=True)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    wgrad = staged_wgrad(fused.wgrad_splits(R * S, BF16), kx, kd)
    names = [n for n, _ in mlp.named_parameters()]
    got = dict(zip(names, (t.numpy() for t in _emulate_bwd_kernels(
        mlp, xd, g, acts, BF16, wgrad=wgrad)[2])))
    plain = dict(zip(names, (t.numpy() for t in fused.nerf_mlp_bwd_plain(
        mlp, xd, g, BF16, acts=acts)[1])))
    assert _median_mean_rel(got, want) <= BF16_MEDIAN_MEAN_REL, _median_mean_rel(got, want)
    for n in names:
        err, err_plain = (np.abs(t - want[n]).max() for t in (got[n], plain[n]))
        assert err <= err_plain + 1e-4 * np.abs(want[n]).max(), (n, err, err_plain)
