"""DKMv3 dense matcher (frozen, inference only) in PyTorch, a port of
lushnerf_tpu/matcher/dkm.

The reference uses GIM's DKMv3 (gim/dkm/models/model_zoo/DKMv3.py) for the
CTE loss's dense correspondences.  The exercised inference path:

  * ResNet50 feature pyramid (resnet.py)
  * GP coarse flow regression, DFN decoding, ConvRefiners (blocks.py)
  * the coarse-to-fine decoder and the symmetric match (matcher.py)

Weights load from the torch checkpoint (`gim_dkm_100h.ckpt`, not in the
repository) with `convert.load_checkpoint`; the modules carry its names.
These are torch ops, not Pallas kernels in the JAX package: nothing here
is a hand-written kernel.
"""

from lushnerf_torch.matcher.dkm.matcher import (  # noqa: F401
    DKM,
    PUBLISHED_DIMS,
    TINY_DIMS,
    DKMDims,
    DKMMatcher,
    dkm_match,
    random_state_dict,
)
