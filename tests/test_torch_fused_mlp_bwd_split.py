"""The f32 dgrad kernel's split (lushnerf_torch/csrc/nerf_mlp_dgrad.cu, its
f32 mode) on the CPU, where no kernel runs (chip_smoke.py holds the kernel
against nerf_mlp_bwd_plain on the card).  At width 256 on 64 points and a
ragged 37:
  * the f32 transposed blob of `pack_params_bwd`, undone by a plain index
    model of its layout (`split_blocks`), gives back each block's hi part
    as fp16(W^T 2^4) exactly and (hi + lo) 2^-4 within 2^-21 of the
    block's largest weight, with the padded PE rows zero in both parts;
  * the split dgrad read from that blob as the kernel reads it (each d_z
    row at its own power-of-two scale, split in two fp16 parts, each
    product as hi.hi + lo.hi + hi.lo in f32, the epilogue in f32 on true
    values) reproduces `nerf_mlp_bwd_plain` in f32 -- d(xd), every d_z,
    the bias, head and weight grads -- within 1e-4 of each tensor's max,
    and the JAX Pallas kernel's f32 backward (jax.grad, interpret mode) at
    the same limit;
  * it is equivariant: at g 2^-20 every output is 2^-20 times its output at
    g, bit for bit; the control, the same split without the row scale
    (unscaled fp16 parts), misses the limit there.
The f32 wgrad kernel's split (lushnerf_torch/csrc/nerf_mlp_bwd.cu), on that
emulated dgrad at 300 points in 5 point splits and at the 64 points of the
JAX comparison:
  * `dz_scale_units`, the scale units the f32 dgrad writes beside dz, are,
    index by index, the largest 2^-r of the emulated dgrad's row exponents
    r over each tile's nonzero rows p % 3 == w;
  * the split wgrad (dz at a power of two per point split and d_z block,
    taken from those units; activations and PE unscaled; three fp16
    products into f32; the partials summed in split order) reproduces
    `nerf_mlp_bwd_plain` and the JAX kernel's f32 backward within 1e-4 of
    each grad's max, at g ~ N(0, 1) and at a cotangent shaped like the
    shipped configs' step (half the points 0, |g| log-uniform over
    2^-28..2^-17, random signs);
  * it is equivariant at g 2^-20, bit for bit; the control, the same wgrad
    on unscaled fp16 parts of dz, misses the limit at the shipped-shaped
    cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lushnerf_torch.convert import mlp_state_from_jax
from lushnerf_torch.ops.encoding import posenc, posenc_backward
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_fused_mlp import _xd
from tests.test_torch_fused_mlp_bwd import setup  # noqa: F401  (the fixture)
from tests.test_torch_fused_mlp_bwd import _jax_grads, _mlp, _rel_err, _weights, split_blocks
from lushnerf_tpu.models.renderer import RenderConfig as JRenderConfig
from lushnerf_tpu.ops.fused import nerf_mlp as jfused

LIMIT = 1e-4  # each tensor's max |error| over its max |value| (chip_smoke.py's BWD_TOL in f32)
DT = fused.DGRAD_TILE  # points a tile of the dgrad, the scale units' granularity
SCALE_EXP = 15  # a d_z row's largest |value| is split at [2^14, 2^15) (mirrors the kernel)
SHIFT = fused.SPLIT_SHIFT
WD, WH = 256, 128


def row_parts(t, scaled=True):
    """The kernel's A operand from true values t [P][K]: each row times 2^r,
    r the power of two that puts its largest |value| in [2^14, 2^15) (0 for
    a zero row; `scaled=False`: r = 0, the control), split in fp16 hi and
    lo.  Returns (hi, lo, r) in float."""
    m = t.abs().amax(1)
    r = torch.where(m > 0, SCALE_EXP - torch.frexp(m).exponent, 0) if scaled else \
        torch.zeros(t.shape[0], dtype=torch.int32)
    x = t * torch.exp2(r.float())[:, None]  # exact
    hi = x.half().float()
    return hi, (x - hi).half().float(), r


def _split_mm(his, los, scaled):
    def mm(t, i):  # t [P][K] @ block i^T: three fp16 products, the row scale taken back
        hi, lo, r = row_parts(t, scaled)
        acc = hi @ his[i].T + lo @ his[i].T + hi @ los[i].T
        return acc * torch.exp2(-(r.float() + SHIFT))[:, None]
    return mm


def _plain_mm(mats):
    return lambda t, i: t @ mats[i].T


def emulate(mlp, xd, g, acts, mm, wgrad=None):
    """The dgrad chain on the stash `acts` with block products `mm`, then
    the wgrad (plain f32 z^T A, or `wgrad(z, A, units)` with the scale
    units of z's d_z block) and the bias and head sums, all on true f32
    values: (d_xd, {d_z by name}, the grads of mlp.parameters())."""
    kx, kd = fused.pe_widths(mlp.cfg)
    fp = fused.pack_params(mlp, "float32")[1]
    s = acts.float()
    a = [s[:, l * WD:(l + 1) * WD] for l in range(8)]
    feat, hv = s[:, 8 * WD:9 * WD], s[:, 9 * WD:]
    wr = fp[fused.FP_WR:].reshape(3, WH)
    wa = fp[fused.FP_WA:fused.FP_WR]
    dz = {"hv": (g[:, :3] @ wr) * (hv > 0)}
    d_pe_d = mm(dz["hv"], 11)
    dz["feat"] = mm(dz["hv"], 10)
    dz[7] = (mm(dz["feat"], 9) + g[:, 3:4] * wa) * (a[7] > 0)
    dz[6] = mm(dz[7], 8) * (a[6] > 0)
    dz[5] = mm(dz[6], 7) * (a[5] > 0)
    dz[4] = mm(dz[5], 6) * (a[4] > 0)
    for l in (3, 2, 1, 0):
        dz[l] = mm(dz[l + 1], l + 1) * (a[l] > 0)
    d_pe_x = mm(dz[0], 0) + mm(dz[5], 5)
    d_xd = torch.cat([posenc_backward(xd[:, 0:3], d_pe_x[:, :mlp.cfg.input_ch], 10),
                      posenc_backward(xd[:, 3:6], d_pe_d[:, :mlp.cfg.input_ch_views], 4),
                      xd.new_zeros(xd.shape[0], 2)], 1)
    pe = torch.cat([torch.nn.functional.pad(posenc(xd[:, 0:3], 10), (0, kx - mlp.cfg.input_ch)),
                    torch.nn.functional.pad(posenc(xd[:, 3:6], 4), (0, kd - mlp.cfg.input_ch_views))], 1)
    # the f32 wgrad into the weight blob's layout: (dZ, A, block, column offset, row length)
    wsizes = [WD * kx] + [WD * WD] * 4 + [WD * (kx + WD)] + [WD * WD] * 3 + [WH * (WD + kd)]
    woff = np.concatenate([[0], np.cumsum(wsizes)])
    dw = torch.zeros(int(woff[-1]))
    jobs = [(dz[0], pe[:, :kx], 0, 0, kx)] + [(dz[l], a[l - 1], l, 0, WD) for l in range(1, 5)] + [
        (dz[5], pe[:, :kx], 5, 0, kx + WD), (dz[5], a[4], 5, kx, kx + WD), (dz[6], a[5], 6, 0, WD),
        (dz[7], a[6], 7, 0, WD), (dz["feat"], a[7], 8, 0, WD), (dz["hv"], feat, 9, 0, WD + kd),
        (dz["hv"], pe[:, kx:], 9, WD, WD + kd)]
    # the weight block's index is its d_z's block in dz (d_feat 8, d_hv 9)
    units = None if wgrad is None else fused.dz_scale_units(dz_matrix(dz))
    for z, A, blk, col0, ldw in jobs:
        view = dw[int(woff[blk]):int(woff[blk + 1])].reshape(-1, ldw)
        view[:, col0:col0 + A.shape[1]] = z.T @ A if wgrad is None else wgrad(z, A, units[:, blk])
    dfp = torch.zeros(fused.FP_NUMEL)
    for l in range(8):
        dfp[l * WD:(l + 1) * WD] = dz[l].sum(0)
    dfp[fused.FP_BF:fused.FP_BV] = dz["feat"].sum(0)
    dfp[fused.FP_BV:fused.FP_BA] = dz["hv"].sum(0)
    dfp[fused.FP_BA] = g[:, 3].sum()
    dfp[fused.FP_BR:fused.FP_BR + 3] = g[:, :3].sum(0)
    dfp[fused.FP_WA:fused.FP_WR] = g[:, 3] @ a[7]
    dfp[fused.FP_WR:] = (g[:, :3].T @ hv).reshape(-1)
    return d_xd, dz, fused._unpack_grads(mlp, dw, dfp)


def dz_matrix(dz):
    """The d_z of `emulate` laid out as the dgrad's dz scratch [P, ACTS_LD]:
    d_z_l at columns 256 l, d_feat at 8 * 256, d_hv at 9 * 256."""
    return torch.cat([dz[l] for l in range(8)] + [dz["feat"], dz["hv"]], 1)


def split_wgrad(n_splits, scaled=True):
    """The f32 wgrad kernel's arithmetic on one weight block: z [P][O] (a
    d_z block) and A [P][I], over the kernel's point splits; each split's dz
    times 1 / U, U the largest of `units` [tiles, 3] over the 128-point
    tiles the split touches (`scaled=False`: U = 1, the control), split in
    fp16 parts, as are A's; hi.hi + lo.hi + hi.lo in f32 times U, summed in
    split order."""
    def wgrad(z, A, units):
        P = z.shape[0]
        per = fused.wgrad_pts_per_split(P, n_splits)
        ah, al = (t.float() for t in fused.split_f16(A, 0))
        out = torch.zeros(z.shape[1], A.shape[1])
        for k0 in range(0, P, per):
            k1 = min(P, k0 + per)
            u = units[k0 // DT:(k1 - 1) // DT + 1].max()
            e = int(torch.frexp(u).exponent) - 1 if scaled and u > 0 else 0
            zh, zl = (t.float() for t in fused.split_f16(z[k0:k1], -e))
            acc = zh.T @ ah[k0:k1] + zl.T @ ah[k0:k1] + zh.T @ al[k0:k1]
            out = out + acc * 2.0 ** e
        return out
    return wgrad


def _inputs(setup, P):
    _, params, pts, dirs = setup
    mlp = _mlp(params).requires_grad_(False)
    xd = _xd(pts, dirs)[:P].contiguous()
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((P, 4)).astype(np.float32))
    _, acts = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    return mlp, xd, g, acts


def _split(mlp, scaled=True):
    kx, kd = fused.pe_widths(mlp.cfg)
    his, los = split_blocks(fused.pack_params_bwd(mlp, "float32"), kx, kd)
    return _split_mm(his, los, scaled)


def _worst(got, want):
    """The largest max |error| / max |value| over pairs of tensors."""
    return max(_rel_err(a.numpy(), b.numpy()) for a, b in zip(got, want))


def test_split_blob_gives_back_every_block(setup):
    mlp, _, _, _ = _inputs(setup, 8)
    kx, kd = fused.pe_widths(mlp.cfg)
    wt = fused.pack_params_bwd(mlp, "float32")
    assert wt.dtype == torch.float16
    his, los = split_blocks(wt, kx, kd)
    scale = 2.0 ** SHIFT
    for want, hi, lo in zip(fused.bwd_mats(mlp), his, los):
        assert torch.equal(hi, (want * scale).half().float())
        back = (hi.double() + lo.double()) / scale
        assert (back - want.double()).abs().max() <= 2.0 ** -21 * want.abs().max()
        assert torch.equal(hi == 0, want == 0) and not lo[want == 0].any()
    # the padded PE rows of W0^T, W5a^T and Wvd^T are zero in both parts
    for i, ch in ((0, mlp.cfg.input_ch), (5, mlp.cfg.input_ch), (11, mlp.cfg.input_ch_views)):
        assert not his[i][ch:].any() and not los[i][ch:].any()
    assert fused.pack_params_bwd(mlp, "float32") is wt  # cached
    with pytest.raises(ValueError, match="range"):
        with torch.no_grad():
            mlp.pts_linears[2].weight[0, 0] = 5000.0
        fused.pack_params_bwd(mlp, "float32")


@pytest.mark.parametrize("P", [64, 37], ids=["tile", "ragged"])
def test_split_dgrad_reproduces_plain_f32(setup, P):
    mlp, xd, g, acts = _inputs(setup, P)
    d_xd, dz, grads = emulate(mlp, xd, g, acts, _split(mlp))
    want_xd, want = fused.nerf_mlp_bwd_plain(mlp, xd, g, "float32", acts=acts)
    assert _worst([d_xd] + grads, [want_xd] + want) <= LIMIT
    # every d_z against the same chain on the f32 weights (the plain backward's)
    _, dz_plain, grads_plain = emulate(mlp, xd, g, acts, _plain_mm(fused.bwd_mats(mlp)))
    assert set(dz) == set(dz_plain) and len(dz) == 10
    assert _worst([dz[k] for k in dz], [dz_plain[k] for k in dz]) <= LIMIT
    assert _worst(grads_plain, want) <= 1e-5  # the emulated wgrad and sums are the plain ones


def test_split_dgrad_reproduces_jax_kernel_f32(setup):
    jcfg, params, pts, dirs = setup
    _, _, want = _jax_grads(params, jcfg, pts, dirs, "float32", "stash")
    mlp = _mlp(params).requires_grad_(False)
    xd = _xd(pts, dirs)
    raw, acts = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    g = torch.cos(raw) * _weights()  # the cotangent of sum(sin(raw) * [0, 1, 2, 3])
    _, _, grads = emulate(mlp, xd, g, acts, _split(mlp))
    names = [n for n, _ in mlp.named_parameters()]
    for n, t in zip(names, grads):
        assert _rel_err(t.numpy(), want[n]) <= LIMIT, (n, _rel_err(t.numpy(), want[n]))


def test_split_dgrad_is_equivariant_and_the_unscaled_control_fails(setup):
    mlp, xd, g, acts = _inputs(setup, 64)
    small = 2.0 ** -20
    d_xd, dz, grads = emulate(mlp, xd, g, acts, _split(mlp))
    d_xd_s, dz_s, grads_s = emulate(mlp, xd, g * small, acts, _split(mlp))
    for a, b in zip([d_xd] + [dz[k] for k in dz] + grads, [d_xd_s] + [dz_s[k] for k in dz] + grads_s):
        assert torch.equal(a * small, b)
    # without the row scale the fp16 parts of values ~2^-20 are subnormal
    _, want = fused.nerf_mlp_bwd_plain(mlp, xd, g * small, "float32", acts=acts)
    assert _worst(grads_s, want) <= LIMIT
    _, _, grads_u = emulate(mlp, xd, g * small, acts, _split(mlp, scaled=False))
    assert _worst(grads_u, want) > LIMIT


def shipped_cotangent(shape, seed):
    """A cotangent shaped like the one reaching a scene MLP in the shipped
    configs' step: half the points 0, the rest |g| log-uniform over
    2^-28 .. 2^-17 with random signs (numpy seed)."""
    rng = np.random.default_rng(seed)
    g = 2.0 ** rng.uniform(-28, -17, shape) * rng.choice([-1.0, 1.0], shape)
    return (g * (rng.uniform(size=shape[:-1] + (1,)) < 0.5)).astype(np.float32)


def _inputs_wide(setup, cot):
    """The setup's MLP at 300 points (3 rays x 100 samples, numpy seed 11)
    with its f32 stash and a cotangent: 'normal' (N(0, 1)) or 'shipped'."""
    _, params, _, _ = setup
    rng = np.random.default_rng(11)
    pts = rng.standard_normal((3, 100, 3)).astype(np.float32)
    dirs = rng.standard_normal((3, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mlp = _mlp(params).requires_grad_(False)
    xd = _xd(pts, dirs)
    g = torch.from_numpy(shipped_cotangent((300, 4), 12) if cot == "shipped" else
                         rng.standard_normal((300, 4)).astype(np.float32))
    _, acts = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    return mlp, xd, g, acts


def test_dz_scale_units_by_index(setup):
    mlp, xd, g, acts = _inputs_wide(setup, "shipped")
    _, dz, _ = emulate(mlp, xd, g, acts, _split(mlp))
    units = fused.dz_scale_units(dz_matrix(dz))
    P = xd.shape[0]
    assert units.shape == (-(-P // DT), fused.ZS_BLOCKS, fused.ZS_WARPS)
    assert units.dtype == torch.float32
    for b, name in enumerate(list(range(8)) + ["feat", "hv"]):
        _, _, r = row_parts(dz[name])  # the emulated dgrad's row exponents
        live = dz[name].abs().amax(1) > 0
        for t in range(units.shape[0]):
            for w in range(fused.ZS_WARPS):
                rows = [p for p in range(t * DT + w, min(P, (t + 1) * DT), 3) if live[p]]
                want = max((2.0 ** -int(r[p]) for p in rows), default=0.0)
                assert units[t, b, w].item() == want, (name, t, w)
    # half the points carry a zero cotangent: their rows are zero in every block
    assert not bool(dz_matrix(dz).any(1).all())


@pytest.mark.parametrize("cot", ["normal", "shipped"])
def test_split_wgrad_reproduces_plain_f32(setup, cot):
    mlp, xd, g, acts = _inputs_wide(setup, cot)
    _, _, grads = emulate(mlp, xd, g, acts, _split(mlp), wgrad=split_wgrad(5))
    _, want = fused.nerf_mlp_bwd_plain(mlp, xd, g, "float32", acts=acts)
    assert _worst(grads, want) <= LIMIT


def _jax_grads_at(params, jcfg, pts, dirs, G):
    """{name: grad in the port's layout} of sum(raw * G) through the JAX
    Pallas kernel in f32 (stash backward, interpret mode): its cotangent of
    raw is G."""
    rc = JRenderConfig(mlp_compute_dtype="float32", mlp_bwd="stash")

    def loss(p):
        return jnp.sum(jfused.eval_points_fused(p, jcfg, rc, jnp.asarray(pts), jnp.asarray(dirs),
                                                tile=16) * G)

    with pltpu.force_tpu_interpret_mode():
        gp = jax.grad(loss)(params)
    return {k: v.numpy() for k, v in mlp_state_from_jax(jax.tree.map(np.asarray, gp)).items()}


@pytest.mark.parametrize("cot", ["normal", "shipped"])
def test_split_wgrad_reproduces_jax_kernel_f32(setup, cot):
    jcfg, params, pts, dirs = setup
    R, S = pts.shape[:2]
    G = (shipped_cotangent((R, S, 4), 13) if cot == "shipped" else
         np.random.default_rng(13).standard_normal((R, S, 4)).astype(np.float32))
    want = _jax_grads_at(params, jcfg, pts, dirs, G)
    mlp = _mlp(params).requires_grad_(False)
    xd = _xd(pts, dirs)
    _, acts = fused.nerf_mlp_fwd_plain(mlp, xd, "float32", with_acts=True)
    g = torch.from_numpy(G.reshape(R * S, 4))
    n_splits = fused.wgrad_splits(R * S, "float32")
    _, _, grads = emulate(mlp, xd, g, acts, _split(mlp), wgrad=split_wgrad(n_splits))
    for (n, _), t in zip(mlp.named_parameters(), grads):
        assert _rel_err(t.numpy(), want[n]) <= LIMIT, (n, _rel_err(t.numpy(), want[n]))


def test_split_wgrad_is_equivariant_and_the_unscaled_control_fails(setup):
    mlp, xd, g, acts = _inputs_wide(setup, "shipped")
    small = 2.0 ** -20
    _, _, grads = emulate(mlp, xd, g, acts, _split(mlp), wgrad=split_wgrad(5))
    _, _, grads_s = emulate(mlp, xd, g * small, acts, _split(mlp), wgrad=split_wgrad(5))
    for a, b in zip(grads, grads_s):
        assert torch.equal(a * small, b)
    # without the split's scale the fp16 parts of dz (|dz| << 2^-14) are
    # subnormal or zero
    _, want = fused.nerf_mlp_bwd_plain(mlp, xd, g, "float32", acts=acts)
    assert _worst(grads, want) <= LIMIT
    _, _, grads_u = emulate(mlp, xd, g, acts, _split(mlp), wgrad=split_wgrad(5, scaled=False))
    assert _worst(grads_u, want) > LIMIT


def test_wgrad_ablate_patches_match_the_source():
    """The f32 wgrad's ablation tool patches csrc/nerf_mlp_bwd.cu by text:
    every text it replaces is in the source, once."""
    from lushnerf_torch.ops.fused import build
    from lushnerf_torch.scripts import wgrad_ablate
    src = (build.CSRC / "nerf_mlp_bwd.cu").read_text()
    for part, patches in wgrad_ablate.PATCHES.items():
        for old, _ in patches:
            assert src.count(old) == 1, part
    assert set(p for v in wgrad_ablate.VARIANTS.values() for p in v) == set(wgrad_ablate.PATCHES)
