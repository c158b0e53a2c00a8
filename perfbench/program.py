"""What the benchmark takes from the program (lushnerf_torch): its config,
its launch counters, its model's parameters by name.  Imported only by the
drivers, never by the reference."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# lushnerf_torch.ops.fused.nerf_mlp's launch counters
COUNTERS = ("launches", "launches_bwd_stash", "launches_bwd_remat")


def seeds(seed: int, *names: str) -> Dict[str, int]:
    """Independent 32-bit seeds, one a name, from the run's --seed (any
    whole number)."""
    children = np.random.SeedSequence(seed % 2 ** 64).spawn(len(names))
    return {n: int(c.generate_state(1)[0]) for n, c in zip(names, children)}


def make_config(entry: dict, **overrides):
    """The program's Config from a configuration file's "config" keys."""
    from lushnerf_torch.config import Config

    kv = dict(entry["config"])
    kv.update(overrides)
    return Config(**kv)


def zero_launches() -> None:
    from lushnerf_torch.ops.fused import nerf_mlp

    for name in COUNTERS:
        setattr(nerf_mlp, name, 0)


def read_launches() -> Dict[str, int]:
    from lushnerf_torch.ops.fused import nerf_mlp

    return {name: getattr(nerf_mlp, name) for name in COUNTERS}


def named_shapes(model: torch.nn.Module):
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    params = dict(model.named_parameters())
    if params.keys() != weights.keys():
        raise KeyError("the benchmark's weights and the model's parameters differ by name")
    for n, p in params.items():
        p.copy_(weights[n])
