"""Per cent of the MLP forward's roofline in a rendered view
(perfbench/work.py), over the device time of the kernels the mlp_fwd map
names."""

from perfbench import readers


def read(r):
    return readers.roofline(r, "mlp_fwd")
