"""The layouts of the vector cumsum (K6/K7) and the masked dists (K10) of
lushnerf_torch/csrc/raymajor_probe.cu, emulated in torch on the CPU.

Each emulation follows its kernel thread by thread: which thread holds
which 4 floats, where the rays start among them, the shuffles (the
cumsum's segmented scan with steps P * 2^k over the lanes of one channel
class, its segment starts from a ballot of the flags; the dists'
neighbour from lane + 1), the sums across warps and the carry from one
pass of a block to the next, in the kernel's order of f32 additions.  The
emulations are held against the plain versions (the cumsum within
CUMSUM_TOL on per-ray pdfs, its first samples exactly 0; the dists bit for
bit), and at the JAX probe's shapes against the Mosaic kernels' captured
outputs.  The kernels themselves run only on the card, where
chip_smoke.py holds them against the plain versions at these cases.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lushnerf_torch.ops.fused import raymajor
from test_torch_raymajor import _run_captured, jax_probe  # noqa: F401  (a fixture)

F = 4  # floats a thread: one float4


def _lane_shift_up(a: torch.Tensor, o: int) -> torch.Tensor:
    """__shfl_up_sync by o over the lane axis (1) of [warps, 32, ...]: a
    lane below o keeps its own value."""
    if o >= 32:
        return a.clone()
    return torch.cat([a[:, :o], a[:, :-o]], dim=1)


def emulate_excl_cumsum(x: torch.Tensor, S: int, WARPS: int):
    """The vector kernel on x [T*S, c] in groups of WARPS warps (a group of
    one warp carries its sums from pass to pass by a shuffle from the same
    lanes whose sums a group of several puts in shared memory): returns
    (y, writes), writes[f] the number of stores to float f."""
    n, c = x.numel(), x.shape[1]
    T, L = x.shape[0] // S, S * c
    assert c in raymajor.VEC_CHANNELS, "a c the vector kernel does not take"
    rpb = raymajor.cumsum_rays_per_block(S, c, WARPS)
    threads = 32 * WARPS
    CM, P = min(c, F), max(c // F, 1)
    m, s = raymajor.divider(L)
    flat = x.reshape(-1)
    y = torch.full((n,), float("nan"))
    writes = torch.zeros(n, dtype=torch.int64)
    tid = torch.arange(threads)
    lane = (tid % 32).view(WARPS, 32)
    r = lane % P  # channel class
    jj = torch.arange(32)
    same = (jj[None, :] % P) == (jj[:, None] % P)  # [lane, j]: j in lane's class
    le, lt = jj[None, :] <= jj[:, None], jj[None, :] < jj[:, None]
    for b in range((T + rpb - 1) // rpb):
        start = b * rpb * L
        end = min(start + rpb * L, n)
        q_end = (end + F - 1) // F
        carry = torch.zeros(P, CM)
        q0 = start // F
        while q0 < q_end:
            q = q0 + tid
            f0 = F * q
            idx = f0[:, None] + torch.arange(F)
            v = torch.where(idx < n, flat[idx.clamp(max=n - 1)], torch.zeros(()))
            p0 = f0 - ((f0 * m) >> s) * L  # f0 % L by the multiply and shift
            if L >= F:  # one ray start at most, at float h
                h = torch.where(p0 == 0, torch.zeros_like(p0), L - p0)
                heads = torch.stack([h == k for k in range(F)], 1)
            else:  # several: walk the places
                p, heads = p0.clone(), []
                for k in range(F):
                    heads.append(p == 0)
                    p = torch.where(p + 1 == L, torch.zeros_like(p), p + 1)
                heads = torch.stack(heads, 1)
            assert torch.equal(heads, (idx % L) == 0)
            run = torch.zeros(len(tid), CM)
            loc = torch.zeros(len(tid), F)
            after = torch.zeros(len(tid), F, dtype=torch.bool)
            seen = torch.zeros(len(tid), dtype=torch.bool)
            for k in range(F):  # the thread's floats, restarting at a ray start
                if k % CM == 0:
                    run = torch.where(heads[:, k, None], torch.zeros(()), run)
                    seen |= heads[:, k]
                else:  # a ray starts only at a float k % CM == 0
                    assert not bool(heads[:, k].any())
                after[:, k] = seen
                loc[:, k] = run[:, k % CM]
                run[:, k % CM] = run[:, k % CM] + v[:, k]
            first_row = (p0 < c).view(WARPS, 32)
            flag = seen.view(WARPS, 32) | first_row
            starts = flag[:, None, :] & same[None]  # [warp, lane, j]: class starts at j
            upto = starts & le[None]
            seg = torch.where(upto.any(-1), (upto * (jj + 1)).amax(-1) - 1, torch.full((), -1))
            frm = seg.clamp(min=0)
            a = run.view(WARPS, 32, CM)
            o = P
            while o < 32:  # the segmented scan over the class's lanes
                u = _lane_shift_up(a, o)
                a = torch.where((lane - o >= frm)[..., None], a + u, a)
                o *= 2
            e = _lane_shift_up(a, P)
            e_starts = (starts & lt[None]).any(-1)
            wsum = a[:, 32 - P:]  # [warp, class, CM]
            wflag = (flag[:, None, :] & same[32 - P:][None]).any(-1)  # [warp, class]
            pre = carry[r]  # [warp, lane, CM]
            for w in range(WARPS - 1):  # the warps before, in order
                later = (torch.arange(WARPS) > w)[:, None, None]
                fw = wflag[w][r][..., None]
                pre = torch.where(later, torch.where(fw, wsum[w][r], pre + wsum[w][r]), pre)
            inc = torch.where(e_starts[..., None], e,
                              torch.where((lane >= P)[..., None], pre + e, pre))
            inc = inc.reshape(-1, CM)
            reset = after | first_row.reshape(-1)[:, None]
            out = torch.stack([torch.where(reset[:, k], loc[:, k], inc[:, k % CM] + loc[:, k])
                               for k in range(F)], 1)
            keep = (q < q_end)[:, None] & (idx >= start) & (idx < end)
            y[idx[keep]] = out[keep]
            writes.index_add_(0, idx[keep], torch.ones_like(idx[keep]))
            if q0 + threads < q_end:  # the last lanes' sums go to the next pass
                nxt = torch.where((seg >= 0)[..., None], a, pre + a)
                carry = nxt[WARPS - 1, 32 - P:].clone()
            q0 += threads
    return y.view(x.shape), writes


def emulate_masked_dists(z: torch.Tensor, S: int):
    """The dists kernel on z [T*S, 1], a float4 a thread: returns (d,
    writes)."""
    flat = z.reshape(-1)
    n = flat.numel()
    nf, tail = n // F, n % F
    threads = nf + (tail > 0)
    grid = -(-threads // 256) * 256
    m, s = raymajor.divider(S)
    i = torch.arange(grid)
    lane = i % 32
    v = torch.zeros(grid, F)
    v[:nf] = flat[:F * nf].view(nf, F)
    own = ((lane == 31) | (i + 1 == nf)) & (F * i + F < n)
    nxt = torch.where(own, flat[(F * i + F).clamp(max=n - 1)], _lane_shift_down(v[:, 0]))
    v = torch.cat([v, nxt[:, None]], 1)
    d = torch.full((n,), float("nan"))
    writes = torch.zeros(n, dtype=torch.int64)
    f0 = F * i
    p = f0 - ((f0 * m) >> s) * S
    out = torch.zeros(grid, F)
    for k in range(F):
        out[:, k] = torch.where(p == S - 1, torch.zeros(()), v[:, k + 1] - v[:, k])
        p = torch.where(p + 1 == S, torch.zeros_like(p), p + 1)
    d[:F * nf] = out[:nf].reshape(-1)
    writes[:F * nf] += 1
    if tail:  # the thread after the last whole group, one sample at a time
        p = (F * nf) % S
        for f in range(F * nf, n):
            d[f] = 0.0 if p == S - 1 else flat[f + 1] - flat[f]
            writes[f] += 1
            p = 0 if p + 1 == S else p + 1
    return d.view(z.shape), writes


def _lane_shift_down(a: torch.Tensor) -> torch.Tensor:
    """__shfl_down_sync by 1 over each warp of a [threads]: lane 31 keeps
    its own value."""
    w = a.view(-1, 32)
    return torch.cat([w[:, 1:], w[:, 31:]], 1).reshape(-1)


def pdf_input(T, S, c, seed):
    """Per-ray pdfs over S, one per channel: sample_pdf's input."""
    w = np.random.default_rng(seed).random((T, S, c)).astype(np.float32) + 1e-3
    return torch.from_numpy((w / w.sum(1, keepdims=True)).reshape(T * S, c))


VEC_CASES = [case for case in chip_smoke.CUMSUM_CASES if case[2] in raymajor.VEC_CHANNELS]


@pytest.mark.parametrize("group", raymajor.CS_GROUPS)
@pytest.mark.parametrize("T,S,c", VEC_CASES)
def test_excl_cumsum_layout_matches_plain(T, S, c, group):
    x = pdf_input(T, S, c, seed=T * 1000 + S * 10 + c)
    y, writes = emulate_excl_cumsum(x, S, group)
    assert bool((writes == 1).all()), "a float stored other than once"
    want = raymajor.excl_cumsum_plain(x, S)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=chip_smoke.CUMSUM_TOL)
    assert bool((y.view(T, S, c)[:, 0] == 0).all())
    lib = torch.cumsum(x.view(T, S, c), 1) - x.view(T, S, c)
    np.testing.assert_allclose(y.view(T, S, c).numpy(), lib.numpy(), rtol=0,
                               atol=chip_smoke.CUMSUM_TOL)


def test_cumsum_plan():
    """The wrapper's blocks: groups of one warp where a warp's pass holds a
    ray, else a block of eight; the rays a group takes fit in one pass
    with their first float4's offset, or a ray longer than a pass takes a
    group of its own; a c the vector kernel does not take goes to the
    general kernel.  The cases reach both kernels, both groups, every class
    width P, several passes and every offset of a ray start in a float4."""
    for group in raymajor.CS_GROUPS:
        for T, S, c in VEC_CASES:
            rpb = raymajor.cumsum_rays_per_block(S, c, group)
            L = S * c
            assert rpb >= 1
            if rpb > 1 or L + (3 if L % 4 else 0) <= 128 * group:
                assert rpb * L + (3 if L % 4 else 0) <= 128 * group
    plans = {(S, c): raymajor.cumsum_plan(S, c) for T, S, c in chip_smoke.CUMSUM_CASES}
    assert {group for group, _ in plans.values()} == {0, *raymajor.CS_GROUPS}
    for (S, c), (group, rpb) in plans.items():
        assert (group == 0) == (c not in raymajor.VEC_CHANNELS)
        if group:
            assert rpb == raymajor.cumsum_rays_per_block(S, c, group)
        if group == 1:
            assert S * c + (3 if S * c % 4 else 0) <= 128
    widths = {max(c // F, 1) for _, _, c in VEC_CASES}
    assert 1 in widths and len(widths) >= 5
    assert any(S * c > 128 * 8 for _, S, c in VEC_CASES)
    assert {(S * c) % 4 for _, S, c in VEC_CASES} == {0, 1, 2, 3}
    assert [raymajor.cumsum_plan(S, 1) for S in (62, 63, 64, 128)] == [(1, 2), (1, 1), (1, 2),
                                                                        (1, 1)]
    assert not raymajor.index64(raymajor.INDEX32_MAX) and raymajor.index64(raymajor.INDEX32_MAX + 1)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 62, 63, 64, 100, 1000, 3000, 12345, 2**20 + 1,
                               2**31 - 1])
def test_divider(d):
    """The kernels' 32-bit division by S or S * c: exact over 0 <= x < 2^31."""
    m, s = raymajor.divider(d)
    assert 0 < m < 2**32
    rng = np.random.default_rng(d)
    xs = np.concatenate([np.arange(4096), 2**31 - 1 - np.arange(4096),
                         rng.integers(0, 2**31, 20000), d * np.arange(1, 4096) - 1,
                         d * np.arange(1, 4096)])
    xs = torch.from_numpy(xs[(xs >= 0) & (xs < 2**31)].astype(np.int64))
    assert torch.equal((xs * m) >> s, xs // d)


@pytest.mark.parametrize("T,S", chip_smoke.DISTS_CASES)
def test_masked_dists_layout_matches_plain(T, S):
    z = np.sort(np.random.default_rng(T * 1000 + S).random((T, S), np.float32) * 5, 1)
    z = torch.from_numpy(z.reshape(T * S, 1))
    d, writes = emulate_masked_dists(z, S)
    assert bool((writes == 1).all())
    assert torch.equal(d, raymajor.masked_dists_plain(z, S))


def test_cases_take_every_tail():
    assert {T * S % 4 for T, S in chip_smoke.DISTS_CASES} == {0, 1, 2, 3}


@pytest.mark.parametrize("probe", ["probe_p1_batched_cumsum", "probe_p1b_batched_dot",
                                   "probe_p4_masked_roll"])
def test_layouts_match_jax_probe_kernel(jax_probe, probe, monkeypatch):  # noqa: F811
    """At the JAX probe's shapes (T 16, S 64; c 8 for the cumsums) on its
    inputs, against the Mosaic kernel's captured output: the cumsums at
    the probe's atol 1e-5, the dists at its 1e-6."""
    ok, calls = _run_captured(jax_probe, getattr(jax_probe, probe), monkeypatch)
    assert ok and len(calls) == 1
    inputs, want = calls[0]
    x = torch.from_numpy(inputs[0])
    if probe == "probe_p4_masked_roll":
        got, _ = emulate_masked_dists(x, 64)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        assert x.shape == (16 * 64, 8)
        got, _ = emulate_excl_cumsum(x, 64, raymajor.cumsum_plan(64, 8)[0])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
