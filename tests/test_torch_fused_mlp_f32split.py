"""The f32 forward kernel's split (lushnerf_torch/csrc/nerf_mlp_fwd_sm90.cuh,
MODE_F32) on the CPU, where no kernel runs (chip_smoke.py holds the kernel
against its plain version on the card), and the routing of MLPs the
compiled kernel does not cover.  Here:
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
  * a width-128 member of the fused family goes to the plain torch path by
    shape under the 'cuda' backend (no call into the fused path, no
    launch), equal to the torch backend, and the f32 kernel's PE geometry
    is part of the same predicate.
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
from lushnerf_torch import config as cfg_mod
from lushnerf_torch.convert import mlp_state_from_jax
from lushnerf_torch.models import renderer
from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.models.renderer import RenderConfig, eval_points
from lushnerf_torch.ops.encoding import posenc
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_convert import params_like_init
from tests.test_torch_fused_mlp import F32_TOL, _xd, sm90_pe_chunks, split_mats

STASH_TOL = 1e-5  # chip_smoke.py's f32 stash limit: max error over the block's max value


@pytest.fixture(scope="module")
def setup():
    jcfg = JMLPConfig(depth=8, width=256, input_ch=63, input_ch_views=27)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg))
    mlp = NeRFMLP(MLPConfig(depth=8, width=256, input_ch=63, input_ch_views=27),
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
    kx, kd = fused.pe_widths(mlp.cfg)
    w, _ = fused.pack_params(mlp, "float32")
    assert w.dtype == torch.float16 and (w.numel() // fused.FWD_PIECE) % fused.SPLIT_RING == 0
    his, los = split_mats(w, kx, kd)
    scale = 2.0 ** fused.SPLIT_SHIFT
    # the ten f32 matrices in the f32 kernel's K order
    for want, hi, lo in zip(fused.fwd_mats_sm90(mlp, views_pe_first=True), his, los):
        assert torch.equal(hi, (want * scale).half().float())
        back = (hi.double() + lo.double()) / scale
        assert (back - want.double()).abs().max() <= 2.0 ** -21 * want.abs().max()
        assert torch.equal(hi == 0, want == 0) and not lo[want == 0].any()
    # a chunk's lo pieces follow its hi pieces
    n = 256 * 64
    assert w[n:2 * n].abs().max() < w[:n].abs().max() * 2.0 ** -10


def _emulate_split(w, fp, xd, kx, kd, nfx, nfd, drop_lo=False):
    """The f32 kernel's arithmetic read from its blob: each layer's K chunks
    in the kernel's order (W0: the pe_x chunk; W5: a4, then the pe_x chunk;
    Wv: the pe_d chunk, then feat), every activation split in its fp16
    parts (the blob holds those of W 2^4), acc = 2^4 bias + hi(A) hi(W) +
    lo(A) hi(W) + hi(A) lo(W) in f32, relu(acc 2^-4) in f32, the heads on
    the f32 activations.  Returns (raw out, stash).  `drop_lo`: the lo parts as
    zeros (the control: fp16 products)."""
    his, los = split_mats(w, kx, kd)
    nx, d0, nd = sm90_pe_chunks(kx, kd)
    Wd, Wh = 256, 128

    def split(t):
        hi, lo = fused.split_f16(t, 0)
        return hi.float(), lo.float() * (not drop_lo)

    def layer(i, a, bias, relu=True):
        ah, al = split(a)
        wh, wl = his[i], los[i] * (not drop_lo)
        acc_scale = 2.0 ** fused.SPLIT_SHIFT
        acc = (bias * acc_scale + ah @ wh.T + al @ wh.T + ah @ wl.T) / acc_scale
        return torch.relu(acc) if relu else acc

    P = xd.shape[0]
    pe = torch.zeros((P, 128))
    pe[:, :3 + 6 * nfx] = posenc(xd[:, 0:3], nfx)
    pe[:, kx:kx + 3 + 6 * nfd] = posenc(xd[:, 3:6], nfd)
    pe_x, pe_d = pe[:, :64 * nx], pe[:, 64 * d0:64 * (d0 + nd)]
    b = lambda i: fp[i * Wd:(i + 1) * Wd]  # noqa: E731
    acts = [layer(0, pe_x, b(0))]
    for i in range(1, 5):
        acts.append(layer(i, acts[-1], b(i)))
    acts.append(layer(5, torch.cat([acts[-1], pe_x], 1), b(5)))
    for i in (6, 7):
        acts.append(layer(i, acts[-1], b(i)))
    alpha = acts[7] @ fp[fused.FP_WA:fused.FP_WR] + fp[fused.FP_BA]
    feat = layer(8, acts[7], fp[fused.FP_BF:fused.FP_BV], relu=False)
    hv = layer(9, torch.cat([pe_d, feat], 1), fp[fused.FP_BV:fused.FP_BA])
    rgb = hv @ fp[fused.FP_WR:].reshape(3, Wh).T + fp[fused.FP_BR:fused.FP_BR + 3]
    return torch.cat([rgb, alpha[:, None]], 1), torch.cat(acts + [feat, hv], 1)


def _stash_rel_err(got, want):
    blocks = [(l * 256, (l + 1) * 256) for l in range(9)] + [(9 * 256, want.shape[1])]
    return max(((got[:, a:b] - want[:, a:b]).abs().max() / want[:, a:b].abs().max()).item()
               for a, b in blocks)


@pytest.mark.parametrize("S", [16, 7], ids=["tile", "ragged"])
def test_split_reproduces_plain_f32(setup, S):
    _, _, mlp, pts, dirs = setup
    xd = _xd(pts[:, :S], dirs)
    kx, kd = fused.pe_widths(mlp.cfg)
    w, fp = fused.pack_params(mlp, "float32")
    out, stash = _emulate_split(w, fp, xd, kx, kd, 10, 4)
    want, want_stash = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **F32_TOL)
    assert stash.shape == want_stash.shape == (xd.shape[0], fused.ACTS_LD)
    assert _stash_rel_err(stash, want_stash) <= STASH_TOL
    # the control: without the lo parts (fp16 products) the stash fails its
    # limit tenfold and the output moves tenfold
    out_f16, stash_f16 = _emulate_split(w, fp, xd, kx, kd, 10, 4, drop_lo=True)
    assert _stash_rel_err(stash_f16, want_stash) > 10 * STASH_TOL
    assert (out_f16 - want).abs().max() > 10 * (out - want).abs().max()


def test_split_reproduces_jax_kernel_f32(setup):
    jcfg, params, mlp, pts, dirs = setup
    with pltpu.force_tpu_interpret_mode():
        want = jfused.eval_points_fused(
            params, jcfg, JRenderConfig(mlp_compute_dtype="float32"),
            jnp.asarray(pts), jnp.asarray(dirs), tile=16,
        )
    kx, kd = fused.pe_widths(mlp.cfg)
    w, fp = fused.pack_params(mlp, "float32")
    got, _ = _emulate_split(w, fp, _xd(pts, dirs), kx, kd, 10, 4)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), np.asarray(want), **F32_TOL)


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
    """flagship_cfg's shape at width 128 (in the fused family, outside the
    compiled kernel) under the 'cuda' backend: routed by shape to the plain
    torch path, never into the fused path, no launch, equal to the torch
    backend; the kernel itself still refuses it."""
    lc, mlp_cfg, mlp = _width128_model()
    rc = RenderConfig(mlp_backend="cuda", mlp_compute_dtype=dtype)
    assert mlp_cfg.width == 128 and fused.supports(mlp_cfg, rc) and not fused.kernel_covers(mlp_cfg, rc)
    calls = []
    monkeypatch.setattr(fused, "eval_points_fused", lambda *a, **k: calls.append(a))
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, 6, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((3, 3)).astype(np.float32)), dim=-1)
    fused.launches = 0
    got = eval_points(mlp, mlp_cfg, rc, pts, dirs)
    want = eval_points(mlp, mlp_cfg, RenderConfig(mlp_backend="torch"), pts, dirs)
    assert calls == [] and fused.launches == 0
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="width 256"):
        fused.check_kernel_family(mlp_cfg, dtype, 10, 4)
    assert renderer.fused is fused


def test_kernel_covers_follows_the_kernels_geometry():
    """What each mode's kernel covers at width 256: the flagship PE in both;
    a pe_x of 96 padded channels in bf16 only (the f32 kernel holds one PE
    chunk at a time); pe_x of 32 with pe_d in the same chunk in both."""
    cases = {(10, 4): (True, True), (15, 4): (True, False), (4, 4): (True, True),
             (4, 9): (True, False)}
    for (nfx, nfd), want in cases.items():
        cfg = MLPConfig(input_ch=3 + 6 * nfx, input_ch_views=3 + 6 * nfd)
        got = tuple(fused.kernel_covers(cfg, RenderConfig(mlp_backend="cuda", mlp_compute_dtype=dt,
                                                          multires=nfx, multires_views=nfd))
                    for dt in ("bfloat16", "float32"))
        assert got == want, (nfx, nfd, got)
        assert (fused.kernel_gap(cfg, "float32", nfx, nfd) is None) == want[1]
