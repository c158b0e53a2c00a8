"""The port's DKMv3 matcher (lushnerf_torch/matcher/dkm) against
lushnerf_tpu's on the CPU, on random weights of the narrow `TINY_DIMS`
spec from a seed (the JAX params are the same numpy arrays by name): the
primitives (bilinear interpolate, grid_sample, the gather-form local
correlation, the cosine kernel), the GP, the DFN, each scale's
ConvRefiner, the ResNet50 pyramid at a 64x64 input and `dkm_match` end to
end at 64 x 96, within tests/test_dkm.py's rtol / atol 2e-4; `match_many`
against per-pair `match`; the checkpoint's key cleanup and the weight
carry both ways.  The JAX side of every test is one jitted call in a
module fixture (one compile, ~10 s on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lushnerf_tpu.matcher.dkm import blocks as jblocks
from lushnerf_tpu.matcher.dkm import nn as jnn
from lushnerf_tpu.matcher.dkm.convert import from_torch_state_dict
from lushnerf_tpu.matcher.dkm.matcher import dkm_match as jdkm_match
from lushnerf_tpu.matcher.dkm.resnet import resnet50_pyramid
from lushnerf_torch.matcher.dkm import DKM, TINY_DIMS, DKMMatcher, dkm_match, random_state_dict
from lushnerf_torch.matcher.dkm import blocks, convert, nn
from lushnerf_torch.matcher.dkm.matcher import REFINER_SCALES, state_shapes

RTOL = ATOL = 2e-4
HS, WS = 64, 96
RADII = [(2, True), (3, True), (7, True), (1, False)]
COARSE = ["32", "16"]


def _rand(rng, *shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _inputs():
    """Every test's inputs, numpy from seeds."""
    rng = np.random.default_rng(1)
    c, ch = TINY_DIMS.proj_dim, TINY_DIMS.feature_channels()
    inp = {"interp_x": _rand(rng, 2, 4, 6, 9), "gs_img": _rand(rng, 2, 3, 8, 11),
           "gs_grid": _rand(rng, 2, 5, 7, 2, lo=-1.3, hi=1.3),
           "lc_f0": _rand(rng, 2, 8, 10, 12), "lc_f1": _rand(rng, 2, 8, 10, 12),
           "lc_flow": _rand(rng, 2, 2, 10, 12, lo=-1.05, hi=1.05),
           "ck_x": _rand(rng, 2, 12, 16), "ck_y": _rand(rng, 2, 15, 16),
           "resnet_x": rng.random((1, 3, 64, 64), dtype=np.float32),
           "im0": rng.random((3, 48, 64), dtype=np.float32),
           "im1": rng.random((3, 48, 64), dtype=np.float32)}
    for k in COARSE:
        inp[f"gp_x{k}"], inp[f"gp_y{k}"] = _rand(rng, 2, c, 4, 6), _rand(rng, 2, c, 4, 6)
        inp[f"dfn_ctx{k}"] = np.abs(_rand(rng, 2, 384, 4, 6))
    for k in REFINER_SCALES:
        inp[f"cr_x{k}"], inp[f"cr_y{k}"] = (_rand(rng, 2, ch[int(k)], 6, 8) for _ in range(2))
        inp[f"cr_flow{k}"] = _rand(rng, 2, 2, 6, 8, lo=-0.9, hi=0.9)
    return inp


INTERP_SIZES = ((13, 5), (3, 4), (6, 9))


def _jax_all(params, inp):
    """lushnerf_tpu's outputs for every test, in one jitted call."""
    out = {f"interp{size}": jnn.interpolate_bilinear(inp["interp_x"], size)
           for size in INTERP_SIZES}
    out["grid_sample"] = jnn.grid_sample_bilinear(inp["gs_img"], inp["gs_grid"])
    for r, with_flow in RADII:
        out[f"lc{r}"] = jnn.local_correlation(inp["lc_f0"], inp["lc_f1"], r,
                                              inp["lc_flow"] if with_flow else None)
    out["cos_kernel"] = jblocks.cos_kernel(inp["ck_x"], inp["ck_y"], T=0.2)
    for k in COARSE:
        gp = jblocks.gp_forward(params, f"decoder.gps.{k}", inp[f"gp_x{k}"], inp[f"gp_y{k}"])
        out[f"gp{k}"] = gp
        out[f"dfn{k}"] = jblocks.dfn_forward(params, "decoder.embedding_decoder", gp,
                                             inp[f"gp_x{k}"], inp[f"dfn_ctx{k}"], k)
    for k in REFINER_SCALES:
        out[f"cr{k}"] = jblocks.conv_refiner_forward(
            params, f"decoder.conv_refiner.{k}", inp[f"cr_x{k}"], inp[f"cr_y{k}"],
            inp[f"cr_flow{k}"], k)
    out["resnet"] = resnet50_pyramid(params, inp["resnet_x"])
    out["match"] = jdkm_match(params, inp["im0"], inp["im1"], hs=HS, ws=WS)
    return out


@pytest.fixture(scope="module")
def weights():
    """(port module, JAX params) of the same random TINY_DIMS weights."""
    sd = random_state_dict(TINY_DIMS, seed=0)
    model = DKM.from_state_dict(sd).eval()
    params = {k: jnp.asarray(v) for k, v in convert.params_from_module(model).items()}
    return model, params


@pytest.fixture(scope="module")
def ref(weights):
    """(numpy inputs, lushnerf_tpu's outputs on them)."""
    inp = _inputs()
    out = jax.jit(_jax_all)(weights[1], {k: jnp.asarray(v) for k, v in inp.items()})
    return inp, jax.device_get(out)


def _t(inp, key):
    return torch.from_numpy(inp[key])


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_interpolate_and_grid_sample_match_jax(ref):
    inp, want = ref
    for size in INTERP_SIZES:
        _close(nn.interpolate_bilinear(_t(inp, "interp_x"), size), want[f"interp{size}"],
               msg=str(size))
    _close(nn.grid_sample_bilinear(_t(inp, "gs_img"), _t(inp, "gs_grid")), want["grid_sample"])


@pytest.mark.parametrize("radius,with_flow", RADII)
def test_local_correlation_matches_jax(ref, radius, with_flow):
    inp, want = ref
    got = nn.local_correlation(_t(inp, "lc_f0"), _t(inp, "lc_f1"), radius,
                               _t(inp, "lc_flow") if with_flow else None)
    assert got.shape == (2, (2 * radius + 1) ** 2, 10, 12)
    _close(got, want[f"lc{radius}"])


def test_cos_kernel_and_meshgrid_match_jax(ref):
    inp, want = ref
    _close(blocks.cos_kernel(_t(inp, "ck_x"), _t(inp, "ck_y")), want["cos_kernel"])
    # linspace forms its f32 values in another order: within 2 ulp of 1
    _close(nn.meshgrid_coords(5, 7), jnn.meshgrid_coords(5, 7), rtol=0, atol=2.5e-7)


# ---------------------------------------------------------------------------
# blocks of the tiny model
# ---------------------------------------------------------------------------


@torch.no_grad()
@pytest.mark.parametrize("scale", COARSE)
def test_gp_and_dfn_match_jax(weights, ref, scale):
    model, _ = weights
    inp, want = ref
    gp = model.decoder.gps[scale](_t(inp, f"gp_x{scale}"), _t(inp, f"gp_y{scale}"))
    _close(gp, want[f"gp{scale}"])
    # the DFN on the JAX GP's output, so each block is held on its own
    got = model.decoder.embedding_decoder(torch.from_numpy(np.array(want[f"gp{scale}"])),
                                          _t(inp, f"gp_x{scale}"), _t(inp, f"dfn_ctx{scale}"),
                                          scale)
    for g, w, name in zip(got, want[f"dfn{scale}"], ("flow", "certainty", "context")):
        _close(g, w, msg=name)


@torch.no_grad()
@pytest.mark.parametrize("scale", REFINER_SCALES)
def test_conv_refiner_matches_jax(weights, ref, scale):
    model, _ = weights
    inp, want = ref
    got = model.decoder.conv_refiner[scale](_t(inp, f"cr_x{scale}"), _t(inp, f"cr_y{scale}"),
                                            _t(inp, f"cr_flow{scale}"))
    for g, w, name in zip(got, want[f"cr{scale}"], ("certainty", "displacement")):
        _close(g, w, msg=name)


@torch.no_grad()
def test_resnet50_pyramid_matches_jax(weights, ref):
    model, _ = weights
    inp, want = ref
    got = model.encoder(_t(inp, "resnet_x"))
    assert sorted(got) == sorted(want["resnet"]) == [1, 2, 4, 8, 16, 32]
    for s in got:
        assert got[s].shape == want["resnet"][s].shape
        _close(got[s], want["resnet"][s], msg=f"stride {s}")


# ---------------------------------------------------------------------------
# the match
# ---------------------------------------------------------------------------


@torch.no_grad()
def test_dkm_match_end_to_end_matches_jax(weights, ref):
    """The symmetric two-pass match at 64 x 96 from 48 x 64 images: the
    warp [hs, 2 ws, 4] and the certainty (sigmoid, zero where the flow
    leaves [-1, 1])."""
    model, _ = weights
    inp, want = ref
    warp, cert = dkm_match(model, _t(inp, "im0"), _t(inp, "im1"), HS, WS)
    assert warp.shape == (HS, 2 * WS, 4) and cert.shape == (HS, 2 * WS)
    assert 0.0 < float(cert.mean()) < 1.0
    _close(warp, want["match"][0], msg="warp")
    _close(cert, want["match"][1], msg="certainty")


def test_match_many_equals_per_pair_match(weights):
    """The cached rematch path (one encoder pass a view, single-direction
    decoder batches of pair_batch, a part batch at the end) against the
    symmetric per-pair match's query half, and its pixel keypoints and
    max_columns subsample."""
    model, _ = weights
    m = DKMMatcher(model, hs=HS, ws=WS, max_columns=1024, pair_batch=3)
    images = np.random.default_rng(8).random((3, 48, 64, 3), dtype=np.float32)
    pairs = [(0, 1), (1, 0), (2, 0), (0, 0)]
    kpts, cert = m.match_many(images, pairs)
    assert kpts.shape == (4, 1024, 4) and cert.shape == (4, 1024)
    assert kpts.dtype == cert.dtype == np.float32
    for pi, (k, v) in enumerate(pairs):
        k0, k1, c = m.match(images[k], images[v])
        np.testing.assert_array_equal(kpts[pi, :, :2], k0)
        np.testing.assert_allclose(kpts[pi, :, 2:], k1, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(cert[pi], c, rtol=1e-5, atol=1e-6)
    # columns: linspace over the hs x ws grid, in pixel coords of 48 x 64
    idx = np.linspace(0, HS * WS - 1, 1024).astype(int)
    grid = nn.meshgrid_coords(HS, WS).reshape(-1, 2).numpy()[idx]
    np.testing.assert_array_equal(kpts[0, :, 0], 64 * (grid[:, 0] + 1) / 2)
    np.testing.assert_array_equal(kpts[0, :, 1], 48 * (grid[:, 1] + 1) / 2)


def test_bf16_convs_stay_near_f32(weights):
    """conv_dtype bfloat16 (inputs rounded to bf16, f32 accumulation)
    against float32 on the same images, with tests/test_dkm.py's limits for
    the JAX package's bf16 mode: the query grid exact, matched coordinates
    within a pixel where either run is confident, certainties within 0.15
    (mean 0.02)."""
    model, _ = weights
    images = np.random.default_rng(9).random((2, 48, 64, 3), dtype=np.float32)
    outs = {}
    try:
        for cd in ("float32", "bfloat16"):
            outs[cd] = DKMMatcher(model, hs=HS, ws=WS, max_columns=2048, conv_dtype=cd).match(
                images[0], images[1])
    finally:
        model.set_conv_dtype("float32")  # the module's other tests share the model
    (k0f, k1f, cf), (k0b, k1b, cb) = outs["float32"], outs["bfloat16"]
    np.testing.assert_array_equal(k0b, k0f)
    assert not np.array_equal(cb, cf)  # the bf16 rounding did happen
    conf = np.maximum(cf, cb) > 0.3
    assert conf.sum() > 50
    assert np.abs(k1b[conf] - k1f[conf]).max() < 1.0
    assert np.abs(cb - cf).max() < 0.15 and np.abs(cb - cf).mean() < 0.02


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


class Payload:
    """An object a weights-only load must refuse to unpickle."""


def test_checkpoint_cleanup_and_carry_both_ways(weights, tmp_path):
    """A checkpoint's state dict ('model.' prefixes, the fc head,
    num_batches_tracked) cleans up as lushnerf_tpu's converter does,
    loads strictly into a module of its widths and back; a file that needs
    an unpickler beyond tensors is refused, naming the file."""
    model, params = weights
    raw = {"model." + k: v.clone() for k, v in model.state_dict().items()}
    raw["model.encoder.net.fc.weight"] = torch.zeros(10, 32 * TINY_DIMS.resnet_width)
    raw["model.encoder.net.fc.bias"] = torch.zeros(10)
    raw["model.encoder.net.bn1.num_batches_tracked"] = torch.tensor(7)
    cleaned = convert.clean_state_dict(raw)
    jax_cleaned = from_torch_state_dict(raw)
    assert set(cleaned) == set(jax_cleaned) == set(state_shapes(TINY_DIMS)) == set(params)
    for k, v in cleaned.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jax_cleaned[k]), err_msg=k)

    path = tmp_path / "dkm.ckpt"
    torch.save({"state_dict": raw}, path)
    loaded = DKMMatcher.from_pretrained(str(path), device="cpu", hs=HS, ws=WS).model
    back = convert.params_from_module(loaded)
    assert set(back) == set(params)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(params[k]), err_msg=k)
    carried = convert.module_from_params({k: np.asarray(v) for k, v in params.items()})
    for k, v in carried.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k

    bad = tmp_path / "unsafe.ckpt"
    torch.save({"state_dict": raw, "extra": Payload()}, bad)
    with pytest.raises(RuntimeError, match="unsafe.ckpt"):
        DKMMatcher.from_pretrained(str(bad), device="cpu")
    with pytest.raises(FileNotFoundError, match="LUSHNERF_DKM_CKPT"):
        DKMMatcher.from_pretrained(str(tmp_path / "missing.ckpt"), device="cpu")
