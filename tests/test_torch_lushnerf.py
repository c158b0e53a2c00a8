"""The port's slice end to end: forward_kernel and render_image of
lushnerf_torch against lushnerf_tpu, on the same params and the same random
draws (numpy), plus the port's import boundary.

Tolerances: f32 paths 1e-4 (sums in another order, fed through the
importance sampler); the bf16 flagship path against the JAX Pallas kernel
in interpret mode 2e-5 (depth 1e-4): both round every matmul input to bf16
(see tests/test_torch_fused_mlp.py), and the port in f32 would miss these
bounds (2.6e-5 on rgb, 3.5e-4 on depth).
"""

import ast
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as ge
from lushnerf_tpu.models import lushnerf as jl
from lushnerf_torch.config import flagship_cfg
from lushnerf_torch.convert import params_from_jax
from lushnerf_torch.models import lushnerf as tl
from lushnerf_torch.ops.fused import nerf_mlp as fused
from tests.test_torch_convert import jax_params
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
H, W, FOCAL = 16, 16, 12.0
NUM_IMG = 3


def _configs(tiny, backend=None, dtype=None):
    """(port LushConfig, JAX LushConfig) of the flagship config."""
    lc = flagship_cfg(NUM_IMG, tiny=tiny).lush_config()
    jcfg = ge._flagship_cfg(NUM_IMG, tiny=tiny)
    if backend is not None:
        lc = dataclasses.replace(
            lc, render=dataclasses.replace(lc.render, mlp_backend=backend, mlp_compute_dtype=dtype)
        )
        jcfg.mlp_backend = {"torch": "xla", "cuda": "pallas"}[backend]
        jcfg.mlp_compute_dtype = dtype
    return lc, jcfg.lush_config()


def _model(lc, params):
    model = tl.LushNeRF(lc, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    rays_o = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    rays_d = rng.standard_normal((n, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5
    rays = np.stack([rays_o, rays_d], axis=-1)
    return rays, rng.integers(0, NUM_IMG, n), rng.integers(0, 2, n).astype(bool)


def _draws(lc, n_sub, seed):
    rng = np.random.default_rng(seed)
    S, SI = lc.render.n_samples, lc.render.n_importance
    return dict(
        t_rand=rng.random((n_sub, S), dtype=np.float32),
        u_importance=rng.random((n_sub, SI), dtype=np.float32),
        density_noise_coarse=rng.standard_normal((n_sub, S - 1)).astype(np.float32),
        density_noise_fine=rng.standard_normal((n_sub, S + SI - 1)).astype(np.float32),
    )


def _compare_forward(lc, jlc, params, n, tol, depth_tol):
    rays, idx, fq = _batch(n, seed=7)
    rnd = _draws(lc, n * lc.rbk.num_rays_out, seed=8)
    fwd = jax.jit(functools.partial(jl.forward_kernel, cfg=jlc, H=H, W=W, focal=FOCAL, key=None))
    want = fwd(params, rays=jnp.asarray(rays), image_idx=jnp.asarray(idx),
               fq_mask=jnp.asarray(fq), rand_override={k: jnp.asarray(v) for k, v in rnd.items()})
    got = tl.forward_kernel(
        _model(lc, params), lc, H, W, FOCAL, torch.from_numpy(rays), torch.from_numpy(idx),
        None, fq_mask=torch.from_numpy(fq),
        rand_override={k: torch.from_numpy(v) for k, v in rnd.items()},
    )
    assert set(got) == set(want)
    for k in want:
        t = depth_tol if k == "depth" else tol
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=t, atol=t, err_msg=k)


def _compare_render(lc, jlc, params, size, ray_chunk, tol, depth_tol):
    K = np.array([[FOCAL, 0, size / 2], [0, FOCAL, size / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(3, 4, dtype=np.float32)
    c2w[:, 3] = [0.05, -0.02, 0.1]
    render = jax.jit(functools.partial(jl.render_image, cfg=jlc, H=size, W=size,
                                       ray_chunk=ray_chunk))
    want = render(params, K=jnp.asarray(K), c2w=jnp.asarray(c2w))
    got = tl.render_image(_model(lc, params), lc, size, size, K, c2w, ray_chunk)
    for g, w, t in zip(got, want, (tol, tol, depth_tol)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=t, atol=t)


def test_forward_kernel_tiny_flagship():
    lc, jlc = _configs(tiny=True)
    _compare_forward(lc, jlc, jax_params(jlc, seed=11), n=6, tol=1e-4, depth_tol=1e-4)


def test_render_image_tiny_flagship():
    lc, jlc = _configs(tiny=True)
    # 64 rays in chunks of 24: the last chunk is zero-padded
    _compare_render(lc, jlc, jax_params(jlc, seed=12), 8, 24, tol=1e-4, depth_tol=1e-4)


def test_flagship_width256_through_kernel_path_f32():
    """Width 256, 64+64 samples: the port through its fused-kernel path
    (plain version on the CPU, f32) against the JAX 'xla' backend."""
    lc, _ = _configs(tiny=False, backend="cuda", dtype="float32")
    _, jlc = _configs(tiny=False, backend="torch", dtype="float32")
    params = jax_params(jlc, seed=13)
    fused.launches = 0
    _compare_forward(lc, jlc, params, n=4, tol=1e-4, depth_tol=1e-4)
    _compare_render(lc, jlc, params, 4, 8, tol=1e-4, depth_tol=1e-4)
    assert fused.launches == 0  # CPU tensors never launch the kernel


def test_flagship_bf16_against_pallas_kernel():
    """The shipped flagship config (fused kernel, bf16) on 2 rays against
    the JAX Pallas kernel in interpret mode."""
    lc, jlc = _configs(tiny=False)
    assert lc.render.mlp_backend == "cuda" and lc.render.mlp_compute_dtype == "bfloat16"
    with pltpu.force_tpu_interpret_mode():
        _compare_forward(lc, jlc, jax_params(jlc, seed=14), n=2, tol=2e-5, depth_tol=1e-4)


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    lc, _ = _configs(tiny=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.LushNeRF(lc)
    assert tl.LushNeRF(lc, device="cpu").device.type == "cpu"


def test_config_matches_jax_on_scene_files():
    """Every shipped scene config resolves to the same values in both
    packages, with the backend spelled the port's way ('pallas' -> 'cuda')."""
    from lushnerf_tpu.config import Config as JConfig
    from lushnerf_torch.config import Config

    files = sorted((REPO / "configs").iterdir())
    assert files
    for f in files:
        j, t = dataclasses.asdict(JConfig.from_file(f)), dataclasses.asdict(Config.from_file(f))
        assert t.pop("mlp_backend") == {"xla": "torch", "pallas": "cuda"}[j.pop("mlp_backend")]
        assert t == j, f
        lc = Config.from_file(f, num_images=5).lush_config(near=0.0, far=1.0)
        jlc = JConfig.from_file(f, num_images=5).lush_config(near=0.0, far=1.0)
        assert dataclasses.asdict(lc.rbk) == dataclasses.asdict(jlc.rbk), f
        jr = dataclasses.asdict(jlc.render)
        assert all(jr[k] == v for k, v in dataclasses.asdict(lc.render).items()
                   if k != "mlp_backend"), f


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lushnerf_tpu", "__graft_entry__"}


def test_port_imports_no_jax():
    files = sorted((REPO / "lushnerf_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{f}: imports {name}"
