"""The fused MLP's kernel launches a view over the window
(lushnerf_torch.ops.fused.nerf_mlp's counters)."""

from perfbench import readers


def read(r):
    return readers.launches_per_unit(r)
