"""The fused MLP's kernel launches an iteration over the window
(lushnerf_torch.ops.fused.nerf_mlp's counters: forward, stash and remat
backward); a drop to plain torch shows as a drop here."""

from perfbench import readers


def read(r):
    return readers.launches_per_unit(r)
