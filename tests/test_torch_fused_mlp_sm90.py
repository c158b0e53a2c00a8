"""The bf16 forward kernel's design (lushnerf_torch/csrc/nerf_mlp_fwd_sm90.cuh)
on the CPU, where no kernel runs (chip_smoke.py holds the kernel against its
plain version on the card).  Here:
  * the bf16 weight blob that `pack_params` lays out for wgmma, undone by a
    plain index model of its layout, gives back every weight block,
    including the zero-padded PE columns of W0, W5 and Wv;
  * the kernel's arithmetic read from that blob as its layers read it (each
    layer's K chunks: activation chunks, then PE-tile chunks; the heads on
    the bf16-rounded a7 and hv) reproduces `nerf_mlp_fwd_plain` (rtol 1e-4,
    atol 1e-5: the same roundings, the skip and views layers summed in
    another order) and the JAX Pallas kernel in interpret mode (the bf16
    limits of tests/test_torch_fused_mlp.py, whose reason holds here too);
  * the persistent grid's tiles (`fwd_tiles`, the kernel's loop) cover each
    point exactly once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lushnerf_tpu.models.mlp import MLPConfig as JMLPConfig
from lushnerf_tpu.models.mlp import init_nerf_mlp
from lushnerf_tpu.models.renderer import RenderConfig as JRenderConfig
from lushnerf_tpu.ops.fused import nerf_mlp as jfused
from lushnerf_torch.convert import mlp_state_from_jax
from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.encoding import posenc
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_convert import params_like_init
from tests.test_torch_fused_mlp import BF16_TOL, _xd, sm90_mats, sm90_pe_chunks
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

# (input_ch, input_ch_views) -> (kx, kd): the flagship (64, 32), and (96, 32)
# whose W0 and W5 read both PE chunks and whose pe_d starts mid-chunk
CONFIGS = {"flagship": (63, 27), "nfx15": (93, 27)}


def _mlp(in_ch, in_d, seed=0):
    return NeRFMLP(MLPConfig(depth=8, width=256, input_ch=in_ch, input_ch_views=in_d),
                   torch.Generator().manual_seed(seed), torch.device("cpu")).requires_grad_(False)


def _points(P, seed):
    rng = np.random.default_rng(seed)
    xd = np.zeros((P, 8), np.float32)
    xd[:, :3] = rng.uniform(-1, 1, (P, 3))
    d = rng.standard_normal((P, 3))
    xd[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(xd)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sm90_blob_gives_back_every_weight(config):
    """Each of the ten matrices read back by index is its weight in bf16
    with K in the order the kernel reads it, zero in every PE column the
    layer does not read; and the swizzle moves most elements (a layout that
    skipped it would fail)."""
    in_ch, in_d = CONFIGS[config]
    mlp = _mlp(in_ch, in_d)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    nx, d0, nd = sm90_pe_chunks(kx, kd)
    assert (nx, d0, nd) == fused.pe_geometry(mlp.cfg)[3:]
    w, _ = fused.pack_params(mlp, "bfloat16")
    assert w.dtype == torch.bfloat16 and w.numel() % (128 * 64) == 0
    n = 68 + 4 * nx + nd  # the kernel's pieces a tile, padded to an even count
    assert w.numel() // (128 * 64) == n + n % 2
    got = sm90_mats(w, kx, kd)
    r = lambda t: t.bfloat16().float()  # noqa: E731
    pts = [lin.weight for lin in mlp.pts_linears]
    wv = mlp.views_linears[0].weight

    def placed(m, n_chunks, col0):
        out = torch.zeros(m.shape[0], 64 * n_chunks)
        out[:, col0:col0 + m.shape[1]] = m
        return out

    want = [placed(pts[0], nx, 0)] + pts[1:5] + [
        torch.cat([pts[5][:, in_ch:], placed(pts[5][:, :in_ch], nx, 0)], 1)] + pts[6:8] + [
        mlp.feature_linear.weight,
        torch.cat([wv[:, :256], placed(wv[:, 256:], nd, kx - 64 * d0)], 1)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), r(b).numpy())
    # the padded pe_d part of Wv: only its kd-wide window past feat holds weights
    c = 256 + kx - 64 * d0
    assert not got[9][:, 256:c].any() and not got[9][:, c + in_d:].any()
    row_major = torch.cat([r(m).reshape(-1) for m in want])
    assert (w.float()[:row_major.numel()] != row_major).float().mean() > 0.5


def _emulate_sm90(mlp, xd, nfx, nfd):
    """The kernel's arithmetic on its own blob: the PE tile [P][128] in bf16
    (pe_x at [0, in_ch), pe_d at [dx, dx + d_ch): `fused.pe_geometry`);
    each layer one accumulation
    over its K chunks (activation chunks, then PE chunks from pe_c0) with
    f32 bias and relu, its output rounded to bf16 over the activation
    buffer; alpha on the rounded a7, rgb on the rounded hv.  At the MLP's
    width W (the views layer's 128 lanes, zero-padded at width 128)."""
    r = lambda t: t.bfloat16().float()  # noqa: E731
    kx, kd, dx, nx, d0, nd = fused.pe_geometry(mlp.cfg)
    Wd = mlp.cfg.width
    L = fused.layout(Wd)
    w, fp = fused.pack_params(mlp, "bfloat16")
    mats = sm90_mats(w, kx, kd, Wd, dx, 3 + 6 * nfd)
    P = xd.shape[0]
    pe = torch.zeros(P, 128)
    pe[:, :3 + 6 * nfx] = posenc(xd[:, 0:3], nfx)
    pe[:, dx:dx + 3 + 6 * nfd] = posenc(xd[:, 3:6], nfd)
    pe = r(pe)
    act = torch.zeros(P, Wd)
    biases = [fp[l * Wd:(l + 1) * Wd] for l in range(8)] + [
        fp[L.fp_bf:L.fp_bv], fp[L.fp_bv:L.fp_ba]]
    for l in range(10):
        n_act = 0 if l == 0 else Wd // 64
        n_pe = nx if l in (0, 5) else nd if l == 9 else 0
        pe_c0 = d0 if l == 9 else 0
        A = torch.cat([act[:, :64 * n_act], pe[:, 64 * pe_c0:64 * (pe_c0 + n_pe)]], 1)
        v = A @ mats[l].T + biases[l]
        v = v if l == 8 else torch.relu(v)
        if l == 7:
            alpha = r(v) @ fp[L.fp_wa:L.fp_wr] + fp[L.fp_ba]
        act[:, :v.shape[1]] = r(v)
    rgb = act[:, :128] @ fp[L.fp_wr:].reshape(3, 128).T + fp[L.fp_br:L.fp_br + 3]
    return torch.cat([rgb, alpha[:, None]], 1)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sm90_emulation_reproduces_plain(config):
    in_ch, in_d = CONFIGS[config]
    nfx, nfd = (in_ch - 3) // 6, (in_d - 3) // 6
    mlp = _mlp(in_ch, in_d, seed=1)
    xd = _points(96, seed=2)
    got = _emulate_sm90(mlp, xd, nfx, nfd)
    want = fused.nerf_mlp_fwd_plain(mlp, xd, "bfloat16", nfx, nfd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_sm90_emulation_matches_jax_kernel():
    """The same emulation against the JAX Pallas kernel (interpret mode,
    tile 16) on the JAX package's params."""
    jcfg = JMLPConfig(depth=8, width=256, input_ch=63, input_ch_views=27)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg))
    mlp = _mlp(63, 27)
    mlp.load_state_dict(mlp_state_from_jax(params))
    rng = np.random.default_rng(0)
    R, S = 4, 16
    pts = rng.standard_normal((R, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    with pltpu.force_tpu_interpret_mode():
        want = jfused.eval_points_fused(
            params, jcfg, JRenderConfig(mlp_compute_dtype="bfloat16"),
            jnp.asarray(pts), jnp.asarray(dirs), tile=16,
        )
    got = _emulate_sm90(mlp, _xd(pts, dirs), 10, 4)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), np.asarray(want), **BF16_TOL)


@pytest.mark.parametrize("P", [1, 127, 128, 129, 7 * 128 - 3, 4096 * 64 + 37],
                         ids=["1", "127", "128", "129", "odd-tiles", "ragged"])
def test_fwd_tiles_cover_each_point_once(P):
    n_tiles = -(-P // fused.FWD_TILE)
    for n_sm in (1, 3, 132, 10_000):
        n_blocks = fused.fwd_grid(P, n_sm)
        assert 1 <= n_blocks <= min(n_sm, n_tiles)
        tiles = fused.fwd_tiles(P, n_blocks)
        assert len(tiles) == n_blocks and all(tiles)  # no block without a tile
        assert sorted(t for block in tiles for t in block) == list(range(n_tiles))
        covered = np.zeros(P, np.int64)
        for block in tiles:
            for t in block:
                covered[t * fused.FWD_TILE:min(t * fused.FWD_TILE + fused.FWD_TILE, P)] += 1
        assert (covered == 1).all()
        # block 0 takes the most tiles: its stage stamps have a row for each
        assert len(tiles[0]) == max(len(b) for b in tiles)
