"""The mesh of a data-parallel run: what lushnerf_tpu/parallel/mesh.py
becomes with one process per card.

The JAX package lays its devices out as a ('data',) mesh: the ray batch is
sharded over it, the params are replicated and GSPMD inserts the gradient
psum.  GSPMD cannot partition a Mosaic custom call, so the trainer also
registers the mesh for the fused Pallas kernels (`set_kernel_mesh`), which
shard_map over it.  Here a rank is one process driving one card: the data
axis is the process group, each rank runs its kernels on its own rays (a
kernel never sees another rank's points, so there is no kernel mesh to
register), the params are replicated by construction (every rank starts
from the primary's) and the psum is the trainer's one all-reduce a step
(`distributed.all_reduce_mean_`).  No sharding is ported.

What is left of the config's `mesh_shape` is a check: empty (the data axis
over every rank) or a shape whose product is the world.  A mesh larger than
the world is never quietly run on fewer devices, nor a smaller one on more:
both raise.
"""

from __future__ import annotations

import math
from typing import Tuple


def check_mesh_shape(mesh_shape: str, world: int) -> Tuple[int, ...]:
    """The mesh of mesh_shape ("", "4" or "2,2") in a world of `world`
    processes, one card each: (world,) for "", else the shape, which must
    cover exactly the world.  Raises ValueError otherwise."""
    shape = tuple(int(s) for s in str(mesh_shape).split(",") if s.strip())
    if not shape:
        return (world,)
    if min(shape) <= 0 or math.prod(shape) != world:
        raise ValueError(
            f"mesh_shape {mesh_shape!r} needs {math.prod(shape)} devices, but the run has "
            f"{world} process(es) of one card each: leave mesh_shape empty or give a shape "
            f"whose product is {world}")
    return shape
