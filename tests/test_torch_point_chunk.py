"""`point_chunk` in the port, on the CPU:
  * the backward's chunk plan (`nerf_mlp.point_chunks`, the chunks through
    which `BwdLaunch` runs its scratch on the card): every point lies in
    exactly one chunk, every chunk but the last is `point_chunk` rounded up
    to whole 128-point tiles and starts on a tile, `point_chunk` 0 (or one
    that covers P) gives one chunk, and every wgrad point split of a chunk
    (`chunk_wgrad_splits` and `wgrad_pts_per_split` at the chunk's size)
    lies inside it; an unchunked backward keeps `wgrad_splits`, and the
    shipped configs' f32 chunks take splits that fill whole waves;
  * the plain `eval_points` path with a `point_chunk` below P (padded to
    whole chunks, each under `torch.utils.checkpoint` where a gradient is
    needed) against the JAX package's `eval_points` at the same
    `point_chunk` (XLA path, `lax.map` under `jax.checkpoint`): raw, and
    the grads of the points, the view directions and every parameter of a
    sum(raw * G), within rtol 1e-5 / atol 1e-5 (raw) and 1e-5 of each
    grad's largest value; and against the unchunked plain path at the same
    limits, with and without a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lushnerf_tpu.models import mlp as jmlp
from lushnerf_tpu.models import renderer as jren
from lushnerf_torch.convert import mlp_state_from_jax
from lushnerf_torch.models import mlp as tmlp
from lushnerf_torch.models import renderer as tren
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_convert import params_like_init

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_LIMIT = 1e-5  # each grad's max |error| over its max |value|
TILE = fused.DGRAD_TILE
H100_SMS = 132

PLAN_CASES = [(1, 0), (1, 65536), (37, 0), (128, 128), (129, 128), (300, 100), (300, 128),
              (5000, 1000), (327_680, 65_536), (655_360, 65_536), (655_360, 100_000)]


@pytest.mark.parametrize("P,point_chunk", PLAN_CASES, ids=[f"{p}-{c}" for p, c in PLAN_CASES])
def test_chunks_take_every_point_once_in_whole_tiles(P, point_chunk):
    chunks = fused.point_chunks(P, point_chunk)
    seen = np.zeros(P, np.int64)
    for p0, n in chunks:
        assert n > 0 and p0 % TILE == 0
        seen[p0:p0 + n] += 1
    assert (seen == 1).all()
    size = -(-point_chunk // TILE) * TILE
    if point_chunk == 0 or size >= P:
        assert chunks == [(0, P)]
    else:
        assert all(n == size for _, n in chunks[:-1]) and chunks[-1][1] <= size
        assert len(chunks) == -(-P // size)


@pytest.mark.parametrize("dtype", fused.COMPUTE_DTYPES)
@pytest.mark.parametrize("P,point_chunk", PLAN_CASES, ids=[f"{p}-{c}" for p, c in PLAN_CASES])
def test_every_point_split_lies_in_one_chunk(P, point_chunk, dtype):
    """Each chunk's wgrad splits its own points: the splits cover the chunk
    once, none reaches past it, and (bf16) none is empty."""
    chunks = fused.point_chunks(P, point_chunk)
    for p0, n in chunks:
        splits = fused.chunk_wgrad_splits(n, dtype, len(chunks), H100_SMS)
        per = fused.wgrad_pts_per_split(n, splits, dtype)
        bounds = [(p0 + k, p0 + min(n, k + per)) for k in range(0, per * splits, per)]
        live = [(a, b) for a, b in bounds if b > a]
        assert live[0][0] == p0 and live[-1][1] == p0 + n
        assert all(a == b0 for (_, b0), (a, _) in zip(live, live[1:]))
        assert all(p0 <= a < b <= p0 + n for a, b in live)
        if dtype == "bfloat16":
            assert len(live) == splits
        if len(chunks) == 1:  # an unchunked backward keeps its splits
            assert splits == fused.wgrad_splits(n, dtype)


def test_chunked_f32_wgrad_items_fill_whole_waves():
    """The shipped configs' chunks of 65,536 points: the f32 wgrad takes 12
    splits of 5,472 points (two waves of 132 items); a chunk too small for
    whole waves keeps `wgrad_splits`."""
    assert fused.chunk_wgrad_splits(65_536, "float32", 10, H100_SMS) == 12
    assert 12 * fused.WGRAD_TILES == 2 * H100_SMS
    assert fused.wgrad_pts_per_split(65_536, 12) == 5472
    assert fused.chunk_wgrad_splits(65_536, "float32", 1, H100_SMS) == fused.wgrad_splits(65_536, "float32")
    assert fused.chunk_wgrad_splits(1000, "float32", 3, H100_SMS) == fused.wgrad_splits(1000, "float32")
    assert fused.chunk_wgrad_splits(65_536, "bfloat16", 10, H100_SMS) == fused.wgrad_splits(65_536, "bfloat16")


@pytest.fixture(scope="module")
def setup():
    kw = dict(depth=8, width=64, input_ch=63, input_ch_views=27)
    jcfg = jmlp.MLPConfig(**kw)
    params = params_like_init(lambda k: jmlp.init_nerf_mlp(k, jcfg), seed=4)
    mlp = tmlp.NeRFMLP(tmlp.MLPConfig(**kw), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(params), strict=True)
    rng = np.random.default_rng(21)
    R, S = 3, 50  # 150 points: three chunks of 64, the last padded
    pts = rng.uniform(-1, 1, (R, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    G = rng.standard_normal((R, S, 4)).astype(np.float32)
    return jcfg, params, kw, mlp, pts, dirs, G


def _torch_eval(mlp, kw, point_chunk, pts, dirs, G):
    """raw and the grads of sum(raw * G): (raw, d pts, d dirs, {name: d param})."""
    mlp.zero_grad(set_to_none=True)
    p = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    cfg = tren.RenderConfig(point_chunk=point_chunk, mlp_backend="torch")
    raw = tren.eval_points(mlp, tmlp.MLPConfig(**kw), cfg, p, d)
    (raw * torch.from_numpy(G)).sum().backward()
    return (raw.detach(), p.grad, d.grad,
            {n: q.grad.clone() for n, q in mlp.named_parameters()})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_plain_chunked_eval_points_matches_jax(setup):
    jcfg, params, kw, mlp, pts, dirs, G = setup
    rc = jren.RenderConfig(point_chunk=64)
    assert rc.mlp_backend == "xla"

    def loss(p, x, d):
        raw = jren.eval_points(p, jcfg, rc, x, d)
        return jnp.sum(raw * G), raw

    (_, want_raw), (gp, gx, gd) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(pts), jnp.asarray(dirs))
    want_params = mlp_state_from_jax(jax.tree.map(np.asarray, gp))
    raw, d_pts, d_dirs, grads = _torch_eval(mlp, kw, 64, pts, dirs, G)
    np.testing.assert_allclose(raw.numpy(), np.asarray(want_raw), **TOL)
    assert _rel(d_pts, gx) <= GRAD_LIMIT and _rel(d_dirs, gd) <= GRAD_LIMIT
    assert set(grads) == set(want_params)
    for n, t in grads.items():
        assert _rel(t, want_params[n]) <= GRAD_LIMIT, (n, _rel(t, want_params[n]))


def test_plain_chunked_eval_points_matches_unchunked(setup):
    _, _, kw, mlp, pts, dirs, G = setup
    got = _torch_eval(mlp, kw, 64, pts, dirs, G)
    want = _torch_eval(mlp, kw, 0, pts, dirs, G)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)
    for a, b in zip(got[1:3], want[1:3]):
        assert _rel(a, b) <= GRAD_LIMIT
    for n in want[3]:
        assert _rel(got[3][n], want[3][n]) <= GRAD_LIMIT, n
    with torch.no_grad():  # without a gradient each chunk runs plainly
        cfg = tren.RenderConfig(point_chunk=64, mlp_backend="torch")
        raw = tren.eval_points(mlp, tmlp.MLPConfig(**kw), cfg, torch.from_numpy(pts),
                               torch.from_numpy(dirs))
    np.testing.assert_allclose(raw.numpy(), want[0].numpy(), **TOL)
