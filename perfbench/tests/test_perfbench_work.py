"""The yardstick's arithmetic against hand arithmetic."""

import pytest

from perfbench import work


def test_mlp_macs_at_the_published_widths():
    # 63*256 + 7*256^2 + (63+256)*256 + 256 + (256+27)*128 + 3*128
    assert work.mlp_macs(256) == 16_128 + 458_752 + 81_664 + 256 + 36_224 + 384 == 593_408
    assert work.mlp_macs(128, 63, 27) == 157_440
    assert work.flop_per_point(256, 10, 4) == 1_186_816


def test_a_train_iteration():
    pts = work.train_points(1024, 5, 64, 64)
    assert pts == 1024 * 5 * 64 + 1024 * 5 * 128 == 983_040
    fwd = pts * work.flop_per_point(256, 10, 4)
    assert 3 * fwd == pytest.approx(3.50e12, rel=2e-3)
    assert 3 * fwd == 3 * 983_040 * 1_186_816


def test_a_view():
    pts = work.view_points(640, 1120, 64, 64)
    assert pts == 640 * 1120 * 192
    assert pts * work.flop_per_point(256, 10, 4) == pytest.approx(1.633e14, rel=1e-3)


def test_params_and_bytes():
    n = work.mlp_params(256)
    assert n == 593_408 + 8 * 256 + 256 + 1 + 128 + 3
    assert work.fwd_bytes(10, n) == 10 * 48 + 4 * n
    assert work.bwd_bytes(10, n) == 10 * 80 + 8 * n


@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989e12), ("float32", 495e12)])
def test_roofline_share(dtype, peak):
    # compute-bound: 1e12 FLOP at the peak take 1/peak s
    assert work.roofline_share(1e12, 1.0, 1e12 / peak, dtype) == pytest.approx(100.0)
    # byte-bound: 3.35e9 bytes take 1 ms
    assert work.roofline_share(1.0, 3.35e9, 2e-3, dtype) == pytest.approx(50.0)
