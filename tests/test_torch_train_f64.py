"""`trainer.float64_copy`, the float64 reference step that chip_smoke.py
holds both f32 steps against on the card, on the CPU: the plain step runs
in float64 through and through (loss and every grad), leaves the f32
model as it was, and its scene-MLP grads agree with the f32 step's within
F64_SCENE_REL (|g32 - g64| / |g64|, measured <= 4.2e-5 at this size); the
fused path refuses float64 loudly instead of computing it in f32."""

import dataclasses

import numpy as np
import pytest
import torch

from lushnerf_torch.config import flagship_cfg
from lushnerf_torch.models.lushnerf import LushNeRF
from lushnerf_torch.models.mlp import NeRFMLP
from lushnerf_torch.models.renderer import eval_points
from lushnerf_torch.ops.fused import nerf_mlp as fused
from lushnerf_torch.train import trainer

F64_SCENE_REL = 2e-4
H = W = 16
FOCAL = 12.0


def _setup():
    cfg = flagship_cfg(3, tiny=True)
    cfg.point_chunk = 512
    lc = cfg.lush_config()
    lc = dataclasses.replace(lc, render=dataclasses.replace(lc.render, perturb=False,
                                                            raw_noise_std=0.0))
    rng = np.random.default_rng(0)
    n = 32
    ro = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    batch = {"rays": torch.from_numpy(np.stack([ro, rd], -1)),
             "rgbs": torch.from_numpy(rng.random((n, 3), dtype=np.float32)),
             "images_idx": torch.from_numpy(rng.integers(0, 3, n)),
             "fq_mask": torch.from_numpy(rng.integers(0, 2, n).astype(bool))}
    return lc, LushNeRF(lc, seed=0, device="cpu"), batch


@pytest.mark.parametrize("stage", ["naive", "kernel"])
def test_float64_step_runs_in_f64_and_agrees_on_the_scene_mlps(stage):
    lc, model, batch = _setup()
    loss32, _ = trainer.loss_fn(model, lc, H, W, FOCAL, batch, stage)
    loss32.backward()
    g32 = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m64, lc64, b64 = trainer.float64_copy(model, lc, batch)
    assert lc64.render.mlp_backend == "torch" and b64["images_idx"].dtype == torch.int64
    assert all(p.grad is None for p in m64.parameters())
    loss64, _ = trainer.loss_fn(m64, lc64, H, W, FOCAL, b64, stage)
    loss64.backward()
    assert loss64.dtype == torch.float64
    np.testing.assert_allclose(loss32.item(), loss64.item(), rtol=1e-6)
    g64 = {n: p.grad for n, p in m64.named_parameters() if p.grad is not None}
    assert set(g64) == set(g32) and all(g.dtype == torch.float64 for g in g64.values())
    for name, g in g64.items():
        if name.startswith(("mlp_coarse.", "mlp_fine.")):
            diff = (g32[name].double() - g).norm().item()
            assert diff <= F64_SCENE_REL * g.norm().item(), (name, diff)  # 0 where g64 is 0
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k


def test_fused_path_refuses_float64():
    """The scene MLP at width 256 under the 'cuda' backend (the fused
    kernels' family; on CPU tensors their plain versions): float32 points
    run, float64 points raise."""
    cfg = flagship_cfg(3, tiny=False)
    cfg.mlp_backend = "cuda"
    lc = cfg.lush_config()
    assert fused.supports(lc.mlp_cfg, lc.render) and fused.kernel_covers(lc.mlp_cfg, lc.render)
    mlp = NeRFMLP(lc.mlp_cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    pts = torch.rand(2, 4, 3, dtype=torch.float64)
    dirs = torch.nn.functional.normalize(torch.rand(2, 3, dtype=torch.float64), dim=-1)
    with torch.no_grad():
        assert eval_points(mlp, lc.mlp_cfg, lc.render, pts.float(), dirs.float()).shape == (2, 4, 4)
        with pytest.raises(TypeError, match="float32 only"):
            eval_points(mlp, lc.mlp_cfg, lc.render, pts, dirs)
