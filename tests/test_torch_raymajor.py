"""The port's per-ray primitives (lushnerf_torch/ops/fused/raymajor.py) on
the CPU, against the JAX package's Mosaic probe kernels.

`scripts/probe_raymajor_mosaic.py` is imported by path and each probe runs
in interpret mode.  Its kernels are captured by wrapping the module's
`pl.pallas_call`, and each plain version is held against the captured
kernel output on the captured inputs, at the probe's own tolerance: atol
1e-5 for the cumsums (P1, P1b), 1e-6 for the transpose (P2) and the dists
(P4), exact for the searchsorted count (P3).  The CUDA kernels run only on
the card (chip_smoke.py holds them against these plain versions there).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from lushnerf_torch.ops.fused import build
from lushnerf_torch.ops.fused import raymajor
from lushnerf_torch.scripts import probe_raymajor
from tests.jax_kernel_mesh import no_jax_kernel_mesh  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
S = 64


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_raymajor_mosaic", REPO / "scripts" / "probe_raymajor_mosaic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_captured(mod, probe, monkeypatch):
    """Runs `probe` in interpret mode; returns (its verdict, [(inputs,
    output)] of each pallas_call it made, as numpy)."""
    calls = []
    orig = mod.pl.pallas_call

    def capturing(*args, **kwargs):
        fn = orig(*args, **kwargs)

        def run(*inputs):
            out = fn(*inputs)
            calls.append(([np.array(a) for a in inputs], np.array(out)))
            return out
        return run

    monkeypatch.setattr(mod.pl, "pallas_call", capturing)
    with pltpu.force_tpu_interpret_mode():
        ok = probe()
    monkeypatch.setattr(mod.pl, "pallas_call", orig)
    return ok, calls


def _t(a):
    return torch.from_numpy(a)


PLAIN = {  # probe -> (plain version on the captured inputs, atol; None = exact)
    "probe_p1_batched_cumsum": (lambda x, L: raymajor.excl_cumsum_plain(_t(x), S), 1e-5),
    "probe_p1b_batched_dot": (lambda x, L: raymajor.excl_cumsum_plain(_t(x), S), 1e-5),
    "probe_p2_vector_transpose": (lambda x, I: raymajor.ray_transpose_plain(_t(x), S), 1e-6),
    "probe_p3_searchsorted": (lambda cdf, u: raymajor.searchsorted_count_plain(_t(cdf), _t(u)),
                              None),
    "probe_p4_masked_roll": (lambda z: raymajor.masked_dists_plain(_t(z), S), 1e-6),
}


@pytest.mark.parametrize("probe", list(PLAIN))
def test_plain_matches_jax_probe_kernel(jax_probe, probe, monkeypatch):
    ok, calls = _run_captured(jax_probe, getattr(jax_probe, probe), monkeypatch)
    assert ok, f"{probe} fails in interpret mode"
    assert len(calls) == 1
    inputs, want = calls[0]
    plain, atol = PLAIN[probe]
    got = plain(*inputs).numpy()
    assert got.shape == want.shape
    if atol is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_ragged_shape_against_torch_reference():
    """T 5, S 128 and S 37 (not a multiple of a warp), c 3, against torch
    calls written independently of the plain versions."""
    rng = np.random.default_rng(7)
    for T, S_, c in ((5, 128, 3), (5, 37, 1)):
        x = _t(rng.random((T * S_, c), np.float32))
        want = torch.cumsum(x.reshape(T, S_, c), 1) - x.reshape(T, S_, c)
        got = raymajor.excl_cumsum(x, S_)
        np.testing.assert_allclose(got.reshape(T, S_, c).numpy(), want.numpy(), atol=1e-5)
        assert not got.reshape(T, S_, c)[:, 0].any()
        v = x[:, :1].contiguous()
        np.testing.assert_array_equal(raymajor.ray_transpose(v, S_).numpy(),
                                      v.numpy().reshape(T, S_))
        z = _t(np.sort(rng.random((T, S_), np.float32), 1).reshape(T * S_, 1))
        d = raymajor.masked_dists(z, S_).reshape(T, S_)
        zz = z.reshape(T, S_)
        np.testing.assert_array_equal(d[:, :-1].numpy(), torch.diff(zz, dim=1).numpy())
        assert not d[:, -1].any()
        SI = 11
        cdf = _t(np.sort(rng.random((T, S_), np.float32), 1))
        u = _t(rng.random((T, SI), np.float32))
        got = raymajor.searchsorted_count(cdf, u.reshape(T * SI, 1)).reshape(T, SI)
        np.testing.assert_array_equal(got.numpy(),
                                      torch.searchsorted(cdf, u, right=True).float().numpy())


def test_wrappers_check_shapes_and_devices():
    x = torch.zeros((10, 1))
    with pytest.raises(ValueError):
        raymajor.excl_cumsum(x, 3)  # 10 rows are not whole rays of 3
    with pytest.raises(ValueError):
        raymajor.masked_dists(torch.zeros((12, 1), device="meta"), 3)
    with pytest.raises(ValueError):
        raymajor.searchsorted_count(torch.zeros((2, 4)), torch.zeros((4, 1), device="meta"))


def test_probe_main_on_cpu():
    for name in ("launches_excl_cumsum", "launches_transpose", "launches_searchsorted",
                 "launches_masked_dists"):
        setattr(raymajor, name, 0)
    results = probe_raymajor.main(device="cpu")
    assert len(results) == 5 and all(ok for _, ok in results), results
    assert raymajor.launches_excl_cumsum == raymajor.launches_transpose == 0
    assert raymajor.launches_searchsorted == raymajor.launches_masked_dists == 0
    assert build._LIBS.get("raymajor_probe") is None


@pytest.mark.parametrize("T,S_,SI", [(6, 128, 128), (5, 64, 64), (7, 37, 45)])
def test_searchsorted_count_plain_is_searchsorted_right_or_the_count(T, S_, SI):
    """The function the searchsorted kernel keeps: on sorted rows with ties
    it is torch.searchsorted(..., right=True); on unsorted rows (with ties)
    the count of entries <= u, which no binary search gives."""
    rng = np.random.default_rng(T * 1000 + S_)
    u = _t((rng.integers(0, 17, (T, SI)) / 16).astype(np.float32))
    cdf = _t(np.sort(rng.integers(0, 16, (T, S_)) / 16, 1).astype(np.float32))
    got = raymajor.searchsorted_count_plain(cdf, u.reshape(T * SI, 1)).reshape(T, SI)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), torch.searchsorted(cdf, u, right=True).float().numpy())
    unsorted = _t((rng.integers(0, 16, (T, S_)) / 16).astype(np.float32))
    got = raymajor.searchsorted_count_plain(unsorted, u.reshape(T * SI, 1)).reshape(T, SI)
    count = (unsorted.numpy()[:, None, :] <= u.numpy()[:, :, None]).sum(-1)
    np.testing.assert_array_equal(got.numpy(), count.astype(np.float32))


@pytest.mark.parametrize("T,S_", [(5, 64), (5, 128), (3, 37)])
def test_masked_dists_plain_is_diff_with_append(T, S_):
    """masked_dists_plain equals the one PyTorch call chip_smoke.py times
    beside the kernel, torch.diff with the last sample appended, bit for
    bit."""
    rng = np.random.default_rng(S_)
    z = _t(np.sort(rng.random((T, S_), np.float32) * 7, 1).reshape(T * S_, 1))
    zz = z.view(T, S_)
    want = torch.diff(zz, dim=1, append=zz[:, -1:])
    np.testing.assert_array_equal(raymajor.masked_dists_plain(z, S_).reshape(T, S_).numpy(),
                                  want.numpy())
