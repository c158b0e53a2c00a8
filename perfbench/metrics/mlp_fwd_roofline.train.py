"""Per cent of the MLP forward's roofline in a train iteration: the scene MLPs'
forward work (perfbench/work.py) at the configuration dtype's peak, or its
bytes at HBM bandwidth, over the device time of the kernels the mlp_fwd map
names (remat's recomputing launches included)."""

from perfbench import readers


def read(r):
    return readers.roofline(r, "mlp_fwd")
