"""An autouse fixture for the port's test files that run a JAX Pallas
kernel in interpret mode.

lushnerf_tpu's `Trainer.__init__` registers its mesh (8 CPU devices here)
for the fused kernels process-wide (`parallel.mesh.set_kernel_mesh`), and
the JAX package's fused MLP (`ops/fused/nerf_mlp.eval_points_fused`) then
wraps its `pallas_call` in a shard_map over it.  A file that an xdist
worker runs after one that built a JAX Trainer would run its interpret-mode
kernels sharded over that mesh and hang.  Importing the fixture into a test
module clears the mesh for the module and gives the previous one back
after it.
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def no_jax_kernel_mesh():
    from lushnerf_tpu.parallel.mesh import get_kernel_mesh, set_kernel_mesh

    mesh = get_kernel_mesh()
    set_kernel_mesh(None)
    yield
    set_kernel_mesh(mesh)
