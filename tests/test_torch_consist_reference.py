"""The benchmark's consist-step reference (perfbench/reference/consist.py)
against the port's `train_step` in the allkernel stage with a consist
batch, on the CPU at a tiny size of the poster configuration (its widths,
depths and keys; fewer rays and samples, a 9-view scene at 24 x 32): the
loss, the CTE term, the aligned render, every leaf's gradient and Adam's
change of the weights, from the benchmark's weights and a state Adam
already holds.  Certainties straddle the threshold, so the CTE term is in
the loss and its gradient reaches the scene MLPs.
"""

import numpy as np
import pytest
import torch

from lushnerf_torch.train import trainer as tt
from perfbench import harness, program
from perfbench.reference import consist as ref_consist
from perfbench.scene import intrinsics, make_scene
from perfbench.weights import make_weights

TINY = dict(N_rand=64, N_samples=24, N_importance=8, ray_chunk_eval=256, point_chunk=2048)
VIEWS, H, W, FOCAL = 9, 24, 32, 25.6
N_PIX = 6
# both sides run float32 on the CPU through the same published step in
# different orders (the port's fused-path plain versions, the reference's
# plain modules).  Element by element a gradient that is all but 0 is
# rounding, and a point whose relu or importance sample sits at its
# boundary takes the other branch on one side; so the gradient and Adam's
# change are held leaf by leaf by their norms, as the benchmark's check
# holds them (drivers/train.py `gaps`), within the poster.train cell's
# limits for the median leaf and WORST_LEAF for every leaf
LOSS_RTOL = 1e-5
RGB_ATOL = 1e-5
LIMITS = harness.load_json(harness.PKG / "limits" / "poster.train.json")
WORST_LEAF = 1e-2  # seen: 1.2e-3 (a leaf of the RBK, gradients ~1e-7)
gaps = harness.load_module(harness.PKG / "drivers" / "train.py", "perfbench_driver_train").gaps


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("consist_ref")
    entry = harness.load_json(harness.PKG / "configs" / "poster.json")
    entry["config"].update(TINY)
    cfg = program.make_config(entry, basedir=str(tmp / "logs"), tbdir=str(tmp / "tb"),
                              seed=5, i_print=10 ** 9, i_tensorboard=10 ** 9)
    scene = make_scene(17, VIEWS, H, W, FOCAL)
    trainer = tt.Trainer(cfg, data=scene, device="cpu")
    trainer.setup()
    weights = make_weights(program.named_shapes(trainer.model), 23, torch.device("cpu"))
    program.load_weights(trainer.model, weights)
    return trainer, entry["config"], scene, weights


def _draws(c, gen, rays):
    S, SI, std = c["N_samples"], c["N_importance"], c["raw_noise_std"]
    return {"t_rand": torch.rand((rays, S), generator=gen),
            "u_importance": torch.rand((rays, SI), generator=gen),
            "density_noise_coarse": torch.randn((rays, S - 1), generator=gen) * std,
            "density_noise_fine": torch.randn((rays, S + SI - 1), generator=gen) * std}


def _consist(trainer, rng):
    V = len(trainer.i_train)
    pix = rng.uniform(-1.0, [W + 1.0, H + 1.0], (V, N_PIX, 2)).astype(np.float32)
    cert = rng.uniform(0.5, 1.0, (V, N_PIX)).astype(np.float32)
    K = torch.from_numpy(intrinsics(H, W, FOCAL))
    poses = torch.from_numpy(np.ascontiguousarray(trainer.poses[trainer.i_train]))
    return {"K": K, "poses": poses, "align_pix": torch.from_numpy(pix),
            "certainty": torch.from_numpy(cert), "weight": 1e-2, "threshold": 0.8}


def _program_step(trainer, batch, draws, consist):
    seen = {}
    real_render, real_cte = tt.render_aligned_pixels, tt.consistency_loss

    def render(*args):
        seen["rgb"] = real_render(*args)
        return seen["rgb"]

    def cte(*args):
        seen["term"] = real_cte(*args)
        return seen["term"]

    tt.render_aligned_pixels, tt.consistency_loss = render, cte
    try:
        loss, _ = tt.train_step(trainer.model, trainer.optimizer, trainer.scheduler,
                                trainer.lush_cfg, H, W, trainer.focal, batch, "allkernel",
                                trainer.generator, rand_override=draws, consist=consist)
    finally:
        tt.render_aligned_pixels, tt.consistency_loss = real_render, real_cte
    names = {p: k for k, p in trainer.model.named_parameters()}
    grads = {names[p]: p.grad.detach().clone() for p in trainer.model.parameters()}
    return float(loss), float(seen["term"].detach()), seen["rgb"].detach(), grads


def _adam_state(trainer, names):
    """The program's Adam state under the reference's names."""
    out = {"t": 0}
    for k, p in names.items():
        st = trainer.optimizer.state.get(p, {})
        if st:
            out["t"] = int(st["step"])
            out[("m", k)], out[("v", k)] = st["exp_avg"].clone(), st["exp_avg_sq"].clone()
    return out


def test_consist_step_matches_the_reference(setup):
    """Two steps, each from the weights and Adam's state the program holds:
    the first from a fresh Adam, the second from the state the first left
    (the check's case: the steps after the crossing iteration)."""
    trainer, c, scene, weights = setup
    gen = torch.Generator().manual_seed(31)
    rng = np.random.default_rng(37)
    rays = c["N_rand"] * (c["rbk_num_motion"] + 1)
    names = dict(trainer.model.named_parameters())
    for n in range(2):
        batch = trainer.dataset.next_batch(c["N_rand"], trainer.np_rng)
        draws, consist = _draws(c, gen, rays), _consist(trainer, rng)
        before = {k: v.detach().clone() for k, v in names.items()}
        adam = _adam_state(trainer, names)
        assert adam["t"] == n
        lr = trainer.optimizer.param_groups[0]["lr"]
        loss, term, rgb, grads = _program_step(trainer, batch, draws, consist)
        step = {"rays": batch["rays"], "idx": batch["images_idx"].reshape(-1),
                "rgbs": batch["rgbs"], "draws": draws, "consist": consist}
        ref = ref_consist.reference_steps(before, adam, c, scene, [step],
                                          {"lin": "f32", "lin_other": "f32"}, n)
        assert ref["terms"][0] > 0.0  # the CTE term is in the loss
        assert loss == pytest.approx(ref["losses"][0], rel=LOSS_RTOL)
        assert term == pytest.approx(ref["terms"][0], rel=LOSS_RTOL)
        np.testing.assert_allclose(rgb.numpy(), ref["rgb"].numpy(), rtol=0, atol=RGB_ATOL)
        after = {k: v.detach().clone() for k, v in names.items()}
        got = gaps({"losses": [loss], "grad": grads, "after": after}, ref, before)
        assert got["grad_gap_median_leaf"] <= LIMITS["grad_gap_median_leaf"], got
        assert got["change_gap_median_leaf"] <= LIMITS["change_gap_median_leaf"], got
        assert got["grad_gap_worst_leaf"] <= WORST_LEAF, got
        assert got["change_gap_worst_leaf"] <= WORST_LEAF, got
        for k, change in ref["after"].items():  # Adam moved what the reference moved
            assert torch.equal(after[k] == before[k], change == before[k]), k


def test_the_cte_weight_moves_the_reference(setup):
    """At weight 0 the reference's loss is the allkernel loss alone; the CTE
    term changes the scene MLPs' gradient."""
    trainer, c, scene, weights = setup
    gen = torch.Generator().manual_seed(41)
    batch = trainer.dataset.next_batch(c["N_rand"], trainer.np_rng)
    draws = _draws(c, gen, c["N_rand"] * (c["rbk_num_motion"] + 1))
    consist = _consist(trainer, np.random.default_rng(43))
    outs = []
    for weight in (0.0, 1e-2):
        step = {"rays": batch["rays"], "idx": batch["images_idx"].reshape(-1),
                "rgbs": batch["rgbs"], "draws": draws, "consist": dict(consist, weight=weight)}
        outs.append(ref_consist.reference_steps(weights, {"t": 0}, c, scene, [step],
                                                {"lin": "f32", "lin_other": "f32"}, 0))
    zero, full = outs
    assert full["losses"][0] == pytest.approx(zero["losses"][0] + 1e-2 * full["terms"][0],
                                              rel=1e-6)
    leaf = "mlp_fine.rgb_linear.weight"
    assert not torch.equal(zero["grad"][leaf], full["grad"][leaf])
