"""Test isolation across the modules of an xdist worker.

lushnerf_tpu's `Trainer.__init__` registers its mesh (8 CPU devices in the
tests) for the fused Pallas kernels process-wide
(`parallel.mesh.set_kernel_mesh`), and the JAX package's fused MLP then
wraps its `pallas_call` in a shard_map over it.  A module that a worker
runs after one that built a JAX Trainer would run its interpret-mode
kernels sharded over that mesh and hang (tests/test_fused_mlp.py's
`test_forward_parity` did, under `-n 6 --dist loadfile`).  So every module
starts with no kernel mesh and gives the previous one back after it, as
tests/jax_kernel_mesh.py does for the files that import it.  The fixture
touches the registry only once some module has imported it.
"""

import sys

import pytest


@pytest.fixture(autouse=True, scope="module")
def _no_leaked_jax_kernel_mesh():
    mesh_mod = sys.modules.get("lushnerf_tpu.parallel.mesh")
    if mesh_mod is None:
        yield
        return
    previous = mesh_mod.get_kernel_mesh()
    mesh_mod.set_kernel_mesh(None)
    yield
    mesh_mod.set_kernel_mesh(previous)
