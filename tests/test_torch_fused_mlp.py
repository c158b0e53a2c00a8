"""The port's fused NeRF-MLP (lushnerf_torch/ops/fused/nerf_mlp.py) on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py holds it against the
plain version there).  Here:
  * the plain version matches the JAX Pallas kernel (interpret mode,
    tile 16, width 256) -- f32 at rtol 1e-4 / atol 1e-5 as
    tests/test_fused_mlp.py holds the JAX kernel, bf16 at rtol 1e-3 /
    atol 2e-4: both round every matmul input to bf16, but the JAX kernel's
    polynomial sine differs from sin() by ~1e-6, enough to move some PE
    values to the neighbouring bf16 value (a relative step of 2^-8; the
    observed gap is 5e-5 on outputs of magnitude 0.17);
  * the packed weight blobs the kernel reads reproduce the plain version
    when evaluated the way the kernel evaluates them (layout and offsets;
    the bf16 blob read through a plain index model of its wgmma layout,
    `sm90_mats`, the f32 blob through the model of its split layout,
    `split_mats`, with each weight's two bf16 parts added back);
  * a CPU tensor takes the plain version and launches nothing;
  * the 'cuda' backend routes the JAX package's MLP family, and what the
    compiled kernel does not cover raises before a launch.
"""

import os
import subprocess
import sys
from pathlib import Path

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
from lushnerf_torch.models.renderer import RenderConfig, eval_points
from lushnerf_torch.ops.encoding import posenc
from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_convert import params_like_init
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
BF16_TOL = dict(rtol=1e-3, atol=2e-4)
F32_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = JMLPConfig(depth=8, width=256, input_ch=63, input_ch_views=27)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg))
    mlp = NeRFMLP(MLPConfig(depth=8, width=256, input_ch=63, input_ch_views=27),
                  torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(params))
    mlp.requires_grad_(False)
    rng = np.random.default_rng(0)
    R, S = 4, 16
    pts = rng.standard_normal((R, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jcfg, params, mlp, pts, dirs


def _xd(pts, dirs):
    R, S = pts.shape[:2]
    d = np.broadcast_to(dirs[:, None], (R, S, 3))
    xd = np.concatenate([pts, d, np.zeros((R, S, 2), np.float32)], -1)
    return torch.from_numpy(np.ascontiguousarray(xd.reshape(R * S, 8)))


@pytest.mark.parametrize(
    "dtype,S", [("float32", 16), ("bfloat16", 16), ("float32", 7)],
    ids=["f32", "bf16", "f32-ragged"],
)
def test_plain_matches_jax_kernel(setup, dtype, S):
    jcfg, params, mlp, pts, dirs = setup
    pts = pts[:, :S]  # S=7: P = 28, not a multiple of the tile
    with pltpu.force_tpu_interpret_mode():
        want = jfused.eval_points_fused(
            params, jcfg, JRenderConfig(mlp_compute_dtype=dtype),
            jnp.asarray(pts), jnp.asarray(dirs), tile=16,
        )
    got = fused.nerf_mlp_fwd_plain(mlp, _xd(pts, dirs), dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.numpy().reshape(want.shape), np.asarray(want), **tol)


def sm90_pe_chunks(kx, kd, dx=None, d_ch=None):
    """(nx, d0, nd): the PE tile's chunks of 64 columns (pe_x at [0, kx),
    pe_d at [dx, dx + d_ch); by default dx = kx, d_ch = kd) that W0 / W5
    read (the first nx) and Wv reads (nd from d0)."""
    dx, d_ch = (kx if dx is None else dx), (kd if d_ch is None else d_ch)
    return -(-kx // 64), dx // 64, -(-(dx + d_ch) // 64) - dx // 64


def sm90_mats(w, kx, kd, width=256, dx=None, d_ch=None):
    """The bf16 forward blob undone by a plain index model of its layout:
    ten [N][K] matrices one after another (N = the width, the last 128),
    each chunk-major over K in chunks of 64 columns, element (n, k) of a
    chunk at row n, 16-byte piece (k % 64) // 8 moved to piece position
    ((k % 64) // 8) ^ (n % 8).  K of each: W0 [nx PE chunks], W1..W4 [W],
    W5 [W (a4) + nx PE chunks], W6, W7, Wf [W], Wv [W (feat) + nd PE
    chunks]; then, if the count of [128][64] pieces is odd, a zero piece.
    The PE chunks as `sm90_pe_chunks(kx, kd, dx, d_ch)` counts them."""
    nx, _, nd = sm90_pe_chunks(kx, kd, dx, d_ch)
    Wd, Wh = width, 128
    shapes = [(Wd, 64 * nx)] + [(Wd, Wd)] * 4 + [(Wd, Wd + 64 * nx)] + [(Wd, Wd)] * 3 + [
        (Wh, Wd + 64 * nd)]
    flat = w.float().numpy()
    offs = np.concatenate([[0], np.cumsum([a * b for a, b in shapes])])
    pad = 128 * 64 if (offs[-1] // (128 * 64)) % 2 else 0
    assert offs[-1] + pad == flat.size and not flat[offs[-1]:].any()
    mats = []
    for (N, K), off in zip(shapes, offs):
        n, k = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
        idx = (k // 64) * N * 64 + n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8
        mats.append(torch.from_numpy(flat[off:off + N * K][idx]))
    return mats


def sm90_row_major(mats, kx, kd):
    """The ten matrices of the f32 blob's row-major layout, from the bf16
    blob's: W0 [256][kx], W5 [pe_x | a4], Wv [feat | pe_d] (kd columns)."""
    _, d0, _ = sm90_pe_chunks(kx, kd)
    Wd = 256
    c = kx - 64 * d0  # pe_d's first column in Wv's PE chunks
    return [mats[0][:, :kx]] + mats[1:5] + [
        torch.cat([mats[5][:, Wd:Wd + kx], mats[5][:, :Wd]], 1)] + mats[6:9] + [
        torch.cat([mats[9][:, :Wd], mats[9][:, Wd + c:Wd + c + kd]], 1)]


def split_mats(w, kx, kd, width=256, dx=None, d_ch=None):
    """The f32 forward blob undone by a plain index model of its layout:
    the ten [N][K] matrices as lists of their hi and lo parts, K in the
    kernel's order (as `sm90_mats`, but Wv's nd PE chunks before feat; N =
    the width, Wv's 128: at width 128 its 64 rows and 64 zero rows); each
    chunk of 64 columns of a matrix is its [N][64] hi part in the layout of
    `sm90_mats`, then its lo part; then zero pieces up to a multiple of 4
    [128][64] pieces.  The PE chunks as `sm90_pe_chunks(kx, kd, dx, d_ch)`
    counts them."""
    nx, _, nd = sm90_pe_chunks(kx, kd, dx, d_ch)
    Wd, Wh, piece = width, 128, 128 * 64
    shapes = [(Wd, 64 * nx)] + [(Wd, Wd)] * 4 + [(Wd, Wd + 64 * nx)] + [(Wd, Wd)] * 3 + [
        (Wh, 64 * nd + Wd)]
    flat = w.float().numpy()
    offs = np.concatenate([[0], np.cumsum([2 * a * b for a, b in shapes])])
    assert -(-offs[-1] // (4 * piece)) * 4 * piece == flat.size and not flat[offs[-1]:].any()
    his, los = [], []
    for (N, K), off in zip(shapes, offs):
        n, k = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
        base = off + (k // 64) * 2 * N * 64 + n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8
        his.append(torch.from_numpy(flat[base]))
        los.append(torch.from_numpy(flat[base + N * 64]))
    return his, los


def split_unsplit(w, kx, kd):
    """The ten matrices of the f32 blob in the row-major layout of
    `sm90_row_major`, each weight as (hi + lo) 2^-SPLIT_SHIFT (its fp16
    parts' scale taken back)."""
    his, los = split_mats(w, kx, kd)
    mats = [(h + lo) / 2.0 ** fused.SPLIT_SHIFT for h, lo in zip(his, los)]
    nd = sm90_pe_chunks(kx, kd)[2]
    mats[9] = torch.cat([mats[9][:, 64 * nd:], mats[9][:, :64 * nd]], 1)  # feat first
    return sm90_row_major(mats, kx, kd)


def _emulate_kernel(w, fp, xd, kx, kd, nfx, nfd, bf16):
    """The CUDA kernel's arithmetic, read from the packed blobs exactly as
    the kernel reads them (one accumulation over each padded K); the bf16
    blob through the index model of its layout, the f32 blob through the
    model of its split layout with each weight's parts added back."""
    r = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    Wd, Wh = 256, 128
    mats = (sm90_row_major(sm90_mats(w, kx, kd), kx, kd) if bf16 else split_unsplit(w, kx, kd))
    pad = lambda t, k: torch.nn.functional.pad(t, (0, k - t.shape[1]))  # noqa: E731
    pe_x = r(pad(posenc(xd[:, 0:3], nfx), kx))
    pe_d = r(pad(posenc(xd[:, 3:6], nfd), kd))
    b = lambda i: fp[i * Wd:(i + 1) * Wd]  # noqa: E731
    h = torch.relu(pe_x @ mats[0].T + b(0))
    for i in range(1, 5):
        h = torch.relu(r(h) @ mats[i].T + b(i))
    h = torch.relu(torch.cat([pe_x, r(h)], 1) @ mats[5].T + b(5))
    for i in (6, 7):
        h = torch.relu(r(h) @ mats[i].T + b(i))
    alpha = r(h) @ fp[fused.FP_WA:fused.FP_WR] + fp[fused.FP_BA]
    feat = r(h) @ mats[8].T + fp[fused.FP_BF:fused.FP_BV]
    hv = torch.relu(torch.cat([r(feat), pe_d], 1) @ mats[9].T + fp[fused.FP_BV:fused.FP_BA])
    rgb = r(hv) @ fp[fused.FP_WR:].reshape(3, Wh).T + fp[fused.FP_BR:fused.FP_BR + 3]
    return torch.cat([rgb, alpha[:, None]], 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_blobs_reproduce_plain(setup, dtype):
    _, _, mlp, pts, dirs = setup
    xd = _xd(pts, dirs)
    w, fp = fused.pack_params(mlp, dtype)
    assert w.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float16)  # f32: two parts
    assert fp.numel() == fused.FP_NUMEL
    kx, kd = fused.pe_geometry(mlp.cfg)[:2]
    assert (kx, kd) == (64, 32)
    got = _emulate_kernel(w, fp, xd, kx, kd, 10, 4, dtype == "bfloat16")
    want = fused.nerf_mlp_fwd_plain(mlp, xd, dtype)
    # same roundings; the sums (a5 and hv as one accumulation) differ in order
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    assert fused.pack_params(mlp, dtype)[0] is w  # cached per params version
    with torch.no_grad():
        mlp.rgb_linear.bias.add_(1.0)
    assert fused.pack_params(mlp, dtype)[0] is not w
    with torch.no_grad():
        mlp.rgb_linear.bias.sub_(1.0)


def test_cpu_tensor_takes_plain_version_without_launch(setup):
    _, _, mlp, pts, dirs = setup
    fused.launches = 0
    cfg = RenderConfig(mlp_backend="cuda", mlp_compute_dtype="bfloat16")
    got = eval_points(mlp, mlp.cfg, cfg, torch.from_numpy(pts), torch.from_numpy(dirs))
    want = fused.nerf_mlp_fwd_plain(mlp, _xd(pts, dirs), "bfloat16")
    assert fused.launches == 0
    np.testing.assert_array_equal(got.reshape(-1, 4).numpy(), want.numpy())
    assert build._LIBS == {}
    with pytest.raises(ValueError):
        fused.nerf_mlp_fwd(mlp, torch.zeros((4, 8), device="meta"))


SUPPORT_CASES = [
    dict(), dict(width=128), dict(width=384), dict(width=512), dict(width=192),
    dict(depth=4, width=128, rgb_only=True), dict(depth=2, width=16, input_ch=27, input_ch_views=15),
    dict(skips=(3,)), dict(use_viewdirs=False), dict(input_ch=99, input_ch_views=27),
    dict(input_ch=99, input_ch_views=9),
]


def test_supports():
    """The 'cuda' backend routes the same MLP family as JAX's 'pallas'."""
    rc, jrc = RenderConfig(), JRenderConfig()
    got = [fused.supports(MLPConfig(**c), rc) for c in SUPPORT_CASES]
    assert got == [jfused.supports(JMLPConfig(**c), jrc) for c in SUPPORT_CASES]
    assert got[:4] == [True] * 4 and got[-1]


@pytest.mark.parametrize("case,dtype,nfx", [
    (dict(), "float16", 10), (dict(width=384), "bfloat16", 10), (dict(width=512), "float32", 10),
    (dict(input_ch=99, input_ch_views=33), "bfloat16", 16), (dict(), "float32", 9),
], ids=["dtype", "w128", "w512", "pe-padded-over-128", "pe-mismatch"])
def test_kernel_family_check_raises(case, dtype, nfx):
    """What the card's path checks before a launch: members of the routed
    family that the compiled kernels do not cover raise, not fall back
    (width 384 in bf16 under the id "w128", 512 in either dtype; a PE of 99
    + 33 channels, past the 128 lanes, under "pe-padded-over-128"); widths
    256 and 128 pass in both dtypes."""
    cfg = MLPConfig(**case)
    nfd = (cfg.input_ch_views - 3) // 6
    with pytest.raises(ValueError):
        fused.check_kernel_family(cfg, dtype, nfx, nfd)
    for width in (256, 128):
        for dt in ("bfloat16", "float32"):
            fused.check_kernel_family(MLPConfig(width=width), dt, 10, 4)


def test_width128_cuda_backend_on_cpu_takes_plain_version():
    """Width 128 in f32 (the default dtype), which the kernels are built
    for: on CPU tensors the fused path is the plain version, launches
    nothing, and equals the torch backend in f32."""
    cfg = MLPConfig(width=128)
    mlp = NeRFMLP(cfg, torch.Generator().manual_seed(1), torch.device("cpu")).requires_grad_(False)
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.standard_normal((3, 5, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((3, 3)).astype(np.float32)), dim=-1)
    fused.launches = 0
    got = eval_points(mlp, cfg, RenderConfig(mlp_backend="cuda"), pts, dirs)
    want = eval_points(mlp, cfg, RenderConfig(mlp_backend="torch"), pts, dirs)
    assert fused.launches == 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    with pytest.raises(ValueError, match="mlp_compute_dtype"):
        RenderConfig(mlp_backend="cuda", mlp_compute_dtype="float16")


def test_imports_without_nvcc():
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    env["PYTHONPATH"] = str(REPO)
    code = (
        "import lushnerf_torch.ops.fused.nerf_mlp as m, lushnerf_torch.models.lushnerf, "
        "lushnerf_torch.ops.fused.build as b; assert m.launches == 0 and b._LIBS == {}"
    )
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
