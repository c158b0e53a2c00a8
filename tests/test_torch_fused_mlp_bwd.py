"""The gradient of the port's fused NeRF-MLP (NerfMLPFn, nerf_mlp_bwd_plain
in lushnerf_torch/ops/fused/nerf_mlp.py) on the CPU.

The CUDA backward kernels run only on the card (chip_smoke.py holds them
against nerf_mlp_bwd_plain there).  Here, at width 256 on 64 points:
  * the port's CPU path (plain forward + hand-written plain backward)
    against jax.grad of the JAX Pallas kernel (interpret mode, tile 16), for
    f32 and bf16 x stash and remat: grads of the points, the directions and
    all 24 parameters.  Each tensor's max error over its max magnitude:
    f32 <= 2e-5 (measured 5e-6: sums in another order, and the JAX
    kernel's polynomial sine differs from sin() by ~6e-7, which the PE
    derivative scales by up to 2^9); bf16 <= 3e-2 (measured 2e-2): both
    round every matmul input to bf16, but that sine moves a few PE values to
    the neighbouring bf16 value (2^-8 relative), and the backward carries
    each flip through eight layers.  Those flips touch few values, so bf16
    also holds the median over the tensors of mean error / mean magnitude
    to 1e-4 (measured 1.1e-5);
  * autograd through the plain bf16 forward rounds the products' results
    where the TPU kernel rounds its cotangents: every value moves, and that
    median is 1.8e-3, above the bound the hand-written backward meets;
  * stash and remat give the same bits; every parameter gets a grad; a CPU
    tensor launches nothing;
  * the backward's packed blobs (transposed weights, blob-shaped grads)
    reproduce the plain backward when evaluated the way the kernels read
    and write them (the f32 blob's split dgrad itself:
    test_torch_fused_mlp_bwd_split.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lushnerf_tpu.models.mlp import MLPConfig as JMLPConfig
from lushnerf_tpu.models.mlp import init_nerf_mlp
from lushnerf_tpu.models.renderer import RenderConfig as JRenderConfig
from lushnerf_tpu.ops.fused import nerf_mlp as jfused
from lushnerf_torch.convert import mlp_state_from_jax
from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.models.renderer import RenderConfig
from lushnerf_torch.ops.encoding import posenc
from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_convert import params_like_init
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

# max |error| / max |value| of each grad tensor
MAX_REL = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_MEDIAN_MEAN_REL = 1e-4  # median over tensors of mean |error| / mean |value|


@pytest.fixture(scope="module")
def setup():
    jcfg = JMLPConfig(depth=8, width=256, input_ch=63, input_ch_views=27)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg), seed=5)
    rng = np.random.default_rng(1)
    R, S = 4, 16
    pts = rng.standard_normal((R, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jcfg, params, pts, dirs


def _mlp(params):
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(params))
    return mlp


def _weights():
    return torch.arange(4, dtype=torch.float32)


def _jax_grads(params, jcfg, pts, dirs, dtype, mode):
    """(d pts, d dirs, {name: grad in the port's layout}) of
    sum(sin(raw) * [0, 1, 2, 3]) through the JAX Pallas kernel."""
    rc = JRenderConfig(mlp_compute_dtype=dtype, mlp_bwd=mode)

    def loss(p, x, d):
        raw = jfused.eval_points_fused(p, jcfg, rc, x, d, tile=16)
        return jnp.sum(jnp.sin(raw) * jnp.arange(4))

    with pltpu.force_tpu_interpret_mode():
        gp, gx, gd = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(pts), jnp.asarray(dirs))
    gp = jax.tree.map(np.asarray, gp)
    return np.asarray(gx), np.asarray(gd), {k: v.numpy() for k, v in mlp_state_from_jax(gp).items()}


def _port_grads(mlp, pts, dirs, dtype, mode):
    x = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    raw = fused.eval_points_fused(mlp, mlp.cfg, RenderConfig(mlp_backend="cuda", mlp_compute_dtype=dtype,
                                                             mlp_bwd=mode), x, d)
    loss = torch.sum(torch.sin(raw) * _weights())
    names = [n for n, _ in mlp.named_parameters()]
    grads = torch.autograd.grad(loss, [x, d] + list(mlp.parameters()))
    return grads[0].numpy(), grads[1].numpy(), {n: g.numpy() for n, g in zip(names, grads[2:])}


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _mean_rel_err(got, want):
    return np.abs(got - want).mean() / max(np.abs(want).mean(), 1e-30)


def _median_mean_rel(got, want):
    return float(np.median([_mean_rel_err(got[k], want[k]) for k in want]))


def _assert_grads(got, want, dtype):
    (gx, gd, gp), (wx, wd, wp) = got, want
    assert set(gp) == set(wp) and len(gp) == 24
    pairs = [("pts", gx, wx), ("dirs", gd, wd)] + [(k, gp[k], wp[k]) for k in wp]
    for name, g, w in pairs:
        assert g.shape == w.shape, name
        assert _rel_err(g, w) <= MAX_REL[dtype], (name, _rel_err(g, w))
    if dtype == "bfloat16":
        assert _median_mean_rel(gp, wp) <= BF16_MEDIAN_MEAN_REL, _median_mean_rel(gp, wp)


@pytest.mark.parametrize("dtype,mode", [("float32", "stash"), ("float32", "remat"),
                                        ("bfloat16", "stash"), ("bfloat16", "remat")])
def test_grads_match_jax_kernel(setup, dtype, mode):
    jcfg, params, pts, dirs = setup
    want = _jax_grads(params, jcfg, pts, dirs, dtype, mode)
    fused.launches = fused.launches_bwd_stash = fused.launches_bwd_remat = 0
    got = _port_grads(_mlp(params), pts, dirs, dtype, mode)
    assert fused.launches == fused.launches_bwd_stash == fused.launches_bwd_remat == 0
    assert build._LIBS == {}  # a CPU tensor never builds or launches a kernel
    _assert_grads(got, want, dtype)


def test_autograd_through_plain_bf16_forward_misses(setup):
    """Autograd of the plain bf16 forward rounds each product's result, not
    its cotangent input: against the JAX kernel it misses the median bound
    that the hand-written backward meets (test above)."""
    jcfg, params, pts, dirs = setup
    _, _, want = _jax_grads(params, jcfg, pts, dirs, "bfloat16", "remat")
    mlp = _mlp(params)
    R, S = pts.shape[:2]
    xd = np.concatenate([pts, np.broadcast_to(dirs[:, None], (R, S, 3)),
                         np.zeros((R, S, 2), np.float32)], -1).reshape(R * S, 8)
    raw = fused.nerf_mlp_fwd_plain(mlp, torch.from_numpy(xd), "bfloat16")
    loss = torch.sum(torch.sin(raw) * _weights())
    grads = torch.autograd.grad(loss, list(mlp.parameters()))
    names = [n for n, _ in mlp.named_parameters()]
    median = _median_mean_rel({n: g.numpy() for n, g in zip(names, grads)}, want)
    assert median > 10 * BF16_MEDIAN_MEAN_REL, median


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stash_equals_remat_and_every_param_gets_a_grad(setup, dtype):
    _, params, pts, dirs = setup
    mlp = _mlp(params)
    gs = _port_grads(mlp, pts, dirs, dtype, "stash")
    gr = _port_grads(mlp, pts, dirs, dtype, "remat")
    for a, b in zip(gs[:2], gr[:2]):
        np.testing.assert_array_equal(a, b)
    for k in gs[2]:
        np.testing.assert_array_equal(gs[2][k], gr[2][k], err_msg=k)
        assert np.abs(gs[2][k]).max() > 0, k
    # through autograd, every nn.Parameter of the module receives its grad
    x = torch.from_numpy(pts)
    raw = fused.eval_points_fused(mlp, mlp.cfg, RenderConfig(mlp_backend="cuda", mlp_compute_dtype=dtype,
                                                             mlp_bwd="stash"), x, torch.from_numpy(dirs))
    torch.sum(raw * _weights()).backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in mlp.parameters())


@pytest.mark.parametrize("mode", ["stash", "remat"])
def test_param_changed_in_place_before_backward_raises(setup, mode):
    """The Function saves the parameters: a weight updated in place between
    the forward and the backward (an optimizer step before a retained graph
    is backpropagated again) raises instead of giving grads of new weights."""
    _, params, pts, dirs = setup
    mlp = _mlp(params)
    raw = fused.eval_points_fused(mlp, mlp.cfg, RenderConfig(mlp_backend="cuda", mlp_bwd=mode),
                                  torch.from_numpy(pts), torch.from_numpy(dirs))
    with torch.no_grad():
        mlp.pts_linears[3].weight.add_(1.0)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        raw.sum().backward()


def _bwd_sizes(kx, kd, Wd=256, Wh=128):
    """(N, K) of the backward's 12 transposed blocks, [in][out]."""
    return [(kx, Wd)] + [(Wd, Wd)] * 4 + [(kx, Wd)] + [(Wd, Wd)] * 4 + [(Wd, Wh), (kd, Wh)]


def _swizzled_index(N, K):
    """Where element (n, k) of a chunk-major [N][K] block sits: chunk k // 64
    of N rows, row n, 16-byte piece (k % 64) // 8 moved to piece position
    ((k % 64) // 8) ^ (n % 8); without the chunk's offset."""
    n, k = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
    return k // 64, n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8


def split_blocks(wt, kx, kd, width=256):
    """The f32 transposed blob undone by a plain index model of its layout:
    the 12 blocks one after another (at the MLP's `width`; the views
    blocks' 128 lanes), each chunk-major over its K (out) columns in chunks
    of 64; chunk c of a block of N rows is its [N][64] hi part, then its lo
    part, each swizzled as `_swizzled_index` says.  Returns the lists of hi
    and lo blocks, [N][K] in float."""
    flat = wt.float().numpy()
    sizes = _bwd_sizes(kx, kd, width)
    offs = np.concatenate([[0], np.cumsum([2 * n * k for n, k in sizes])])
    assert offs[-1] == flat.size
    his, los = [], []
    for (N, K), off in zip(sizes, offs):
        chunk, at = _swizzled_index(N, K)
        idx = off + chunk * 2 * N * 64 + at
        his.append(torch.from_numpy(flat[idx]))
        los.append(torch.from_numpy(flat[idx + N * 64]))
    return his, los


def _bwd_blocks(mlp, dtype):
    """The 12 blocks of the backward's transposed blob ([in][out]) as the
    kernels read them, undone from the dgrad's layout by a plain index
    model of it: in bf16 each block chunk-major and swizzled
    (`_swizzled_index`); in f32 each chunk's fp16 hi and lo parts
    (`split_blocks`), given back as (hi + lo) 2^-SPLIT_SHIFT."""
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    wt = fused.pack_params_bwd(mlp, dtype)
    if dtype == "float32":
        his, los = split_blocks(wt, kx, kd)
        return [(h + lo) / 2.0 ** fused.SPLIT_SHIFT for h, lo in zip(his, los)]
    flat = wt.float().numpy()
    sizes = _bwd_sizes(kx, kd, mlp.cfg.width)
    offs = np.concatenate([[0], np.cumsum([a * b for a, b in sizes])])
    assert offs[-1] == flat.size
    blocks = []
    for (N, K), off in zip(sizes, offs):
        chunk, at = _swizzled_index(N, K)
        blocks.append(torch.from_numpy(flat[off + chunk * N * 64 + at]))
    return blocks


def _emulate_bwd_kernels(mlp, xd, g, acts, dtype, wgrad=None):
    """The backward kernels' arithmetic read from the packed blobs exactly
    as the CUDA source lays them out: the dgrad chain on the transposed
    blob, d_pe in kx + kd padded columns, the wgrad of the 12 weight-blob
    blocks (the same job table) written into a weight-blob-shaped grad, the
    bias and head grads into an f32-blob-shaped grad; then _unpack_grads.
    `wgrad(dz, stash, pe)`, if given, makes the weight-blob-shaped grad
    from the dgrad's dz scratch [P, acts_ld] (each d_z rounded as the
    kernel stores it), the stash and the PE, all in float.  At the MLP's
    width Wd (the views layer's Wh = 128 lanes, zero-padded at width 128)."""
    r = (lambda t: t.bfloat16().float()) if dtype == "bfloat16" else (lambda t: t)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    Wd, Wh = mlp.cfg.width, 128
    L = fused.layout(Wd)
    fp = fused.pack_params(mlp, dtype)[1]
    T = _bwd_blocks(mlp, dtype)
    s = acts.float()
    a = [s[:, l * Wd:(l + 1) * Wd] for l in range(8)]
    feat, hv = s[:, 8 * Wd:9 * Wd], s[:, 9 * Wd:]
    pe = r(torch.cat([torch.nn.functional.pad(posenc(xd[:, 0:3], 10), (0, kx - 63)),
                      torch.nn.functional.pad(posenc(xd[:, 3:6], 4), (0, kd - 27))], 1))
    gr = r(g)
    wr = fp[L.fp_wr:].reshape(3, Wh)
    d_hv = (gr[:, :3] @ wr) * (hv > 0)
    dz = {"hv": d_hv}
    dz["feat"] = r(d_hv) @ T[10].T
    d7 = (r(dz["feat"]) @ T[9].T + gr[:, 3:4] * fp[L.fp_wa:L.fp_wr]) * (a[7] > 0)
    dz[7] = d7
    dz[6] = (r(dz[7]) @ T[8].T) * (a[6] > 0)
    dz[5] = (r(dz[6]) @ T[7].T) * (a[5] > 0)
    dz[4] = (r(dz[5]) @ T[6].T) * (a[4] > 0)
    for l in (3, 2, 1, 0):
        dz[l] = (r(dz[l + 1]) @ T[l + 1].T) * (a[l] > 0)
    d_pe_x = r(dz[0]) @ T[0].T + r(dz[5]) @ T[5].T
    d_pe_d = r(d_hv) @ T[11].T
    # wgrad into the weight blob: (rows, cols, dZ, A, blob offset, column offset, row length)
    wsizes = [Wd * kx] + [Wd * Wd] * 4 + [Wd * (kx + Wd)] + [Wd * Wd] * 3 + [Wh * (Wd + kd)]
    woff = np.concatenate([[0], np.cumsum(wsizes)])
    dw = torch.zeros(int(woff[-1]))
    jobs = [(dz[0], pe[:, :kx], 0, 0, kx)] + [(dz[l], r(a[l - 1]), l, 0, Wd) for l in range(1, 5)] + [
        (dz[5], pe[:, :kx], 5, 0, kx + Wd), (dz[5], r(a[4]), 5, kx, kx + Wd),
        (dz[6], r(a[5]), 6, 0, Wd), (dz[7], r(a[6]), 7, 0, Wd), (dz["feat"], r(a[7]), 8, 0, Wd),
        (d_hv, r(feat), 9, 0, Wd + kd), (d_hv, pe[:, kx:], 9, Wd, Wd + kd)]
    for z, A, blk, col0, ldw in jobs:
        blockgrad = r(z).T @ A
        view = dw[int(woff[blk]):int(woff[blk + 1])].reshape(-1, ldw)
        view[:, col0:col0 + A.shape[1]] = blockgrad
    if wgrad is not None:
        dw = wgrad(r(torch.cat([dz[l] for l in range(8)] + [dz["feat"], d_hv], 1)), s, pe)
    dfp = torch.zeros(L.fp_numel)
    for l in range(8):
        dfp[l * Wd:(l + 1) * Wd] = dz[l].sum(0)
    dfp[L.fp_bf:L.fp_bv] = dz["feat"].sum(0)
    dfp[L.fp_bv:L.fp_ba] = d_hv.sum(0)
    dfp[L.fp_ba] = g[:, 3].sum()
    dfp[L.fp_br:L.fp_br + 3] = g[:, :3].sum(0)
    dfp[L.fp_wa:L.fp_wr] = gr[:, 3] @ r(a[7])
    dfp[L.fp_wr:] = (gr[:, :3].T @ r(hv)).reshape(-1)
    return d_pe_x[:, :63], d_pe_d[:, :27], fused._unpack_grads(mlp, dw, dfp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_bwd_blobs_reproduce_plain(setup, dtype):
    _, params, pts, dirs = setup
    mlp = _mlp(params).requires_grad_(False)
    R, S = pts.shape[:2]
    rng = np.random.default_rng(2)
    xd = torch.from_numpy(np.concatenate([pts, np.broadcast_to(dirs[:, None], (R, S, 3)),
                                          np.zeros((R, S, 2), np.float32)], -1).reshape(R * S, 8))
    g = torch.from_numpy(rng.standard_normal((R * S, 4)).astype(np.float32))
    _, acts = fused.nerf_mlp_fwd_plain(mlp, xd, dtype, with_acts=True)
    assert acts.shape == (R * S, fused.ACTS_LD) and acts.dtype == fused.stash_dtype(dtype)
    _, _, got = _emulate_bwd_kernels(mlp, xd, g, acts, dtype)
    _, want = fused.nerf_mlp_bwd_plain(mlp, xd, g, dtype, acts=acts)
    assert [t.shape for t in got] == [p.shape for p in mlp.parameters()]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    assert fused.pack_params_bwd(mlp, dtype) is fused.pack_params_bwd(mlp, dtype)  # cached


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_blob_layout_gives_back_the_transposed_weights(setup, dtype):
    """The blob read through the plain index model of its layout holds each
    weight block transposed ([in][out], PE rows past the encoding zero;
    exactly in bf16, in f32 as its two fp16 parts within 2^-21 of the
    block's largest weight), and in bf16 no element sits where the row-major layout would put it for
    more than the unswizzled pieces (a swizzle that did nothing would
    fail)."""
    _, params, _, _ = setup
    mlp = _mlp(params).requires_grad_(False)
    r = (lambda t: t.bfloat16().float()) if dtype == "bfloat16" else (lambda t: t)
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    in_ch, in_d, Wd = mlp.cfg.input_ch, mlp.cfg.input_ch_views, 256
    pts = [lin.weight for lin in mlp.pts_linears]
    wv = mlp.views_linears[0].weight

    def padded_t(w, k):
        return torch.cat([w.T, torch.zeros(k - w.shape[1], w.shape[0])], 0)

    want = [padded_t(pts[0], kx)] + [pts[i].T for i in range(1, 5)] + [
        padded_t(pts[5][:, :in_ch], kx), pts[5][:, in_ch:].T, pts[6].T, pts[7].T,
        mlp.feature_linear.weight.T, wv[:, :Wd].T, padded_t(wv[:, Wd:], kd)]
    got = _bwd_blocks(mlp, dtype)
    assert len(got) == 12 and in_d <= kd
    for a, b in zip(got, want):
        if dtype == "bfloat16":
            np.testing.assert_array_equal(a.numpy(), r(b).numpy())
        else:  # two fp16 parts hold each weight within 2^-21 of the block's largest
            assert (a.double() - b.double()).abs().max() <= 2.0 ** -21 * b.abs().max()
            assert torch.equal(a == 0, b == 0)
    if dtype == "bfloat16":
        flat = fused.pack_params_bwd(mlp, dtype)[:Wd * Wd + kx * Wd].float()
        row_major = torch.cat([r(want[0]).reshape(-1), r(want[1]).reshape(-1)])
        assert (flat != row_major).float().mean() > 0.5


def test_plain_backward_on_the_unpacked_bf16_blob_matches_jax_kernel(setup):
    """The backward emulated on the bf16 blob, undone by the index model,
    gives the JAX Pallas kernel's parameter grads (jax.grad, interpret
    mode) within the bounds the port's CPU path meets."""
    jcfg, params, pts, dirs = setup
    _, _, want = _jax_grads(params, jcfg, pts, dirs, "bfloat16", "stash")
    mlp = _mlp(params).requires_grad_(False)
    R, S = pts.shape[:2]
    xd = torch.from_numpy(np.concatenate([pts, np.broadcast_to(dirs[:, None], (R, S, 3)),
                                          np.zeros((R, S, 2), np.float32)], -1).reshape(R * S, 8))
    raw, acts = fused.nerf_mlp_fwd_plain(mlp, xd, "bfloat16", with_acts=True)
    g = torch.cos(raw) * _weights()  # the cotangent of sum(sin(raw) * [0, 1, 2, 3])
    _, _, grads = _emulate_bwd_kernels(mlp, xd, g, acts, "bfloat16")
    names = [n for n, _ in mlp.named_parameters()]
    got = {n: t.numpy() for n, t in zip(names, grads)}
    for n in names:
        assert _rel_err(got[n], want[n]) <= MAX_REL["bfloat16"], (n, _rel_err(got[n], want[n]))
    assert _median_mean_rel(got, want) <= BF16_MEDIAN_MEAN_REL, _median_mean_rel(got, want)
