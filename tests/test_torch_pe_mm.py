"""The port's PE-only and matmul-only kernels (lushnerf_torch/ops/fused/pe_mm.py)
on the CPU, against the JAX tuning script's Pallas kernels.

`scripts/tune_kernel.py` defines its two kernels inside `main()`; the
`pallas_call`s here have the same bodies (`_pe_forward(xd, C)[1]` and
`_fwd_activations(pe, w, bfloat16)` with its output lanes), run in
interpret mode at tile 32 and P = 96.  The CUDA kernels run only on the
card (chip_smoke.py holds them against these plain versions there).

Tolerances: the PE at atol 2e-6 on NDC-range points and 1e-5 on
standard-normal ones (the JAX kernel's polynomial sine, fitted for
|x| <= 800, against torch.sin of the same float32 arguments); the matmuls
at the forward kernel's bf16 limit (tests/test_torch_fused_mlp.py), both
sides fed the same PE, so that only the order of the sums differs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lushnerf_tpu.models.mlp import MLPConfig as JMLPConfig
from lushnerf_tpu.models.mlp import init_nerf_mlp
from lushnerf_tpu.ops.fused import nerf_mlp as jfused
from lushnerf_torch.convert import mlp_state_from_jax
from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import pe_mm
from lushnerf_torch.scripts import tune_kernel
from tests.test_torch_convert import params_like_init
from tests.test_torch_fused_mlp import BF16_TOL
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

P, TILE = 96, 32


def _jax_pe_only(xd):
    C = jnp.asarray(jfused._pe_consts_np(10, 4))

    def pe_kernel(xd_ref, c_ref, out_ref):
        _, pe = jfused._pe_forward(xd_ref[...], c_ref[...])
        out_ref[...] = pe

    with pltpu.force_tpu_interpret_mode():
        return np.array(pl.pallas_call(
            pe_kernel,
            grid=(xd.shape[0] // TILE,),
            in_specs=[
                pl.BlockSpec((TILE, jfused.XD_CH), lambda i: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((TILE, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((xd.shape[0], 128), jnp.float32),
        )(jnp.asarray(xd), C))


def _jax_mm_only(params, pe):
    w = jfused.pad_params(params, 256)

    def mm_kernel(x_ref, *refs):
        ws = tuple(r[...] for r in refs[:-1])
        out_ref = refs[-1]
        acts = jfused._fwd_activations(x_ref[...], ws, jnp.bfloat16)
        alpha, rgb = acts[8], acts[11]
        out_ref[...] = jnp.concatenate(
            [rgb[:, :4], jnp.zeros_like(rgb[:, :124])], axis=-1) + alpha

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            mm_kernel,
            grid=(pe.shape[0] // TILE,),
            in_specs=[pl.BlockSpec((TILE, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)]
            + [pl.BlockSpec(memory_space=pltpu.VMEM) for _ in w],
            out_specs=pl.BlockSpec((TILE, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((pe.shape[0], 128), jnp.float32),
        )(jnp.asarray(pe), *w))


def _xd(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":  # as the tuning script draws it, lanes 6:8 included
        return rng.standard_normal((P, 8)).astype(np.float32)
    xd = np.zeros((P, 8), np.float32)
    xd[:, :3] = rng.uniform(-1, 1, (P, 3))
    d = rng.standard_normal((P, 3))
    xd[:, 3:6] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return xd


@pytest.mark.parametrize("kind,atol", [("ndc", 2e-6), ("normal", 1e-5)])
def test_pe_only_plain_matches_jax_kernel(kind, atol):
    xd = _xd(kind)
    want = _jax_pe_only(xd)
    pe_mm.launches_pe_only = 0
    got = pe_mm.pe_only(torch.from_numpy(xd)).numpy()
    assert pe_mm.launches_pe_only == 0 and build._LIBS.get("nerf_pe_mm") is None
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert not got[:, 90:].any() and not want[:, 90:].any()
    # identity lanes pass through exactly
    np.testing.assert_array_equal(got[:, 0:3], xd[:, 0:3])
    np.testing.assert_array_equal(got[:, 63:66], xd[:, 3:6])


def test_pe_tables_match_jax():
    np.testing.assert_array_equal(pe_mm._pe_consts_np(10, 4), jfused._pe_consts_np(10, 4))
    np.testing.assert_array_equal(pe_mm._pe_consts_np(7, 2), jfused._pe_consts_np(7, 2))
    assert pe_mm.pe_out_dims(10, 4) == jfused.pe_out_dims(10, 4) == (63, 27)
    # the fixed PE layout of pe_only is the input layout mm_only reads
    cfg = MLPConfig()
    assert pe_mm.pe_out_dims(pe_mm.NUM_FREQS_X, pe_mm.NUM_FREQS_D) == (
        cfg.input_ch, cfg.input_ch_views)


@pytest.fixture(scope="module")
def mlp_pair():
    jcfg = JMLPConfig(depth=8, width=256, input_ch=63, input_ch_views=27)
    params = params_like_init(lambda k: init_nerf_mlp(k, jcfg), seed=5)
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    mlp.load_state_dict(mlp_state_from_jax(params))
    return params, mlp.requires_grad_(False)


def test_mm_only_plain_matches_jax_kernel(mlp_pair):
    params, mlp = mlp_pair
    pe = _jax_pe_only(_xd("ndc", seed=1))  # both sides read the same PE
    want = _jax_mm_only(params, pe)
    pe_mm.launches_mm_only = 0
    got = pe_mm.mm_only(mlp, torch.from_numpy(pe)).numpy()
    assert pe_mm.launches_mm_only == 0
    np.testing.assert_allclose(got[:, :3], want[:, :3], **BF16_TOL)
    assert not got[:, 3:].any() and not want[:, 3:].any()


def test_mm_only_of_pe_only_is_the_forward(mlp_pair):
    """The split composes back to the forward's plain version: lane 0 is
    rgb0 + alpha, lanes 1, 2 are rgb1, rgb2."""
    from lushnerf_torch.ops.fused import nerf_mlp as fused

    _, mlp = mlp_pair
    xd = torch.from_numpy(_xd("ndc", seed=2))
    got = pe_mm.mm_only(mlp, pe_mm.pe_only(xd))
    raw = fused.nerf_mlp_fwd_plain(mlp, xd, "bfloat16")
    want = torch.stack([raw[:, 0] + raw[:, 3], raw[:, 1], raw[:, 2]], 1)
    # the PE's cos lanes are sin(x + pi/2) here and cos(x) in the forward
    np.testing.assert_allclose(got[:, :3].numpy(), want.numpy(), **BF16_TOL)


def test_tune_kernel_main_on_cpu():
    res = tune_kernel.main(device="cpu", P=64)
    assert res["P"] == 64 and res["device"].startswith("cpu")
    for key in ("fwd", "fwd_bwd", "pe_only", "mm_only"):
        med, lo, hi = res[key]
        assert 0 < lo <= med <= hi


def test_pe_ablate_patches_match_both_kernels():
    """The PE-only kernel's ablation tool patches csrc/nerf_pe_mm.cu by text:
    each variant finds exactly one of its texts in this checkout's kernel,
    and none of them twice."""
    from lushnerf_torch.scripts import pe_ablate
    src = (build.CSRC / "nerf_pe_mm.cu").read_text()
    for variant, patches in pe_ablate.PATCHES.items():
        assert sum(src.count(old) for old, _ in patches) == 1, variant
        assert pe_ablate.patched(src, variant) != src
