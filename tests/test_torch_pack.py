"""The fused MLP's weight packs as the pack kernel builds them, on the CPU.

On the card `pack_params` / `pack_params_bwd` are one launch of
lushnerf_torch/csrc/nerf_mlp_pack.cu, which gathers each blob from the
parameters by the codes of `pack_maps` and raises a range flag that the
module's next pack call reads (chip_smoke.py's `pack` phase holds it
against the torch ops there).  Here the kernel's plain version,
`pack_gather`, is held against the torch ops that the CPU runs, bit for
bit, at every geometry the kernels run (widths 256 and 128; PE 10/4,
12/4 and 12/8; f32 and bf16), and its range flag against `split_pieces`'
ValueError; and a flag found by a CUDA pack is raised by the next call.
"""

import math

import pytest
import torch

from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.fused import nerf_mlp as fused

GEOMETRIES = [(w, pe) for w in (256, 128) for pe in ((10, 4), (12, 4), (12, 8))]
LIMIT = fused.FP16_MAX / 2 ** fused.SPLIT_SHIFT  # |w| below it fits the f32 parts
JUST_UNDER = torch.nextafter(torch.tensor(LIMIT), torch.tensor(0.0)).item()  # in f32


def make_mlp(width=256, pe=(10, 4), seed=0):
    cfg = MLPConfig(width=width, input_ch=3 + 6 * pe[0], input_ch_views=3 + 6 * pe[1])
    return NeRFMLP(cfg, torch.Generator().manual_seed(seed), torch.device("cpu"))


def bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def same_bits(got, want):
    return got.dtype == want.dtype and got.shape == want.shape and torch.equal(bits(got),
                                                                                bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,pe", GEOMETRIES, ids=[f"w{w}-pe{a}_{b}" for w, (a, b) in GEOMETRIES])
def test_pack_gather_is_the_torch_pack(width, pe, dtype):
    mlp = make_mlp(width, pe)
    params = list(mlp.parameters())
    (w, fp), bad = fused.pack_gather(params, fused.pack_maps(mlp, dtype, True), dtype)
    (wt,), bad_bwd = fused.pack_gather(params, fused.pack_maps(mlp, dtype, False), dtype)
    want_w, want_fp = fused.pack_params(mlp, dtype)
    assert same_bits(w, want_w) and same_bits(fp, want_fp)
    assert same_bits(wt, fused.pack_params_bwd(mlp, dtype))
    assert not bad and not bad_bwd
    # a second MLP of the config (the fine one) gathers by the same maps
    fine = make_mlp(width, pe, seed=1)
    assert fused.pack_maps(fine, dtype, True) is fused.pack_maps(mlp, dtype, True)
    (w_fine, _), _ = fused.pack_gather(list(fine.parameters()),
                                       fused.pack_maps(fine, dtype, True), dtype)
    assert same_bits(w_fine, fused.pack_params(fine, dtype)[0])


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("value", [5000.0, JUST_UNDER, math.nan, math.inf],
                         ids=["5000", "just_under", "nan", "inf"])
def test_range_flag_where_split_pieces_raises(value, forward):
    mlp = make_mlp()
    with torch.no_grad():
        mlp.pts_linears[2].weight[0, 0] = value
        mlp.views_linears[0].weight[1, 2] = -value
    maps = fused.pack_maps(mlp, "float32", forward)
    _, bad = fused.pack_gather(list(mlp.parameters()), maps, "float32")
    pack = fused.pack_params if forward else fused.pack_params_bwd
    raises = not abs(value) < LIMIT
    assert bad == raises
    if raises:
        who = "pack_params" if forward else "pack_params_bwd"
        with pytest.raises(ValueError, match=f"^{who}: a weight outside .* range"):
            pack(mlp, "float32")
    else:
        pack(mlp, "float32")
    # bf16 takes no split and no range check
    assert not fused.pack_gather(list(mlp.parameters()), fused.pack_maps(mlp, "bfloat16", forward),
                                 "bfloat16")[1]


class _RaisedFlag:
    """A CUDA pack's range flag as the next call finds it raised."""

    def take(self):
        return True


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "bwd"])
def test_flag_of_last_pack_raises_at_next_call(forward):
    mlp = make_mlp(width=128)
    pack = fused.pack_params if forward else fused.pack_params_bwd
    who = "pack_params" if forward else "pack_params_bwd"
    first = pack(mlp, "float32")
    fused._RANGE_FLAGS[mlp] = {who: _RaisedFlag()}
    with pytest.raises(ValueError, match=f"^{who}: a weight outside"):
        pack(mlp, "float32")  # a cache hit reads it too
    del fused._RANGE_FLAGS[mlp]
    again = pack(mlp, "float32")  # the cached blobs were dropped: packed anew
    assert again is not first
    assert all(same_bits(a, b) for a, b in zip(
        again if forward else [again], first if forward else [first]))


def test_pack_source_is_built_beside_the_mlp_sources():
    from lushnerf_torch.models.renderer import RenderConfig

    builds = fused.kernel_builds([make_mlp().cfg], RenderConfig(mlp_backend="cuda"))
    assert builds[0] == (fused.PACK_SOURCE, None)
    assert [b for b in builds if b[0] in fused.SOURCES] == [(s, 256) for s in fused.SOURCES]
