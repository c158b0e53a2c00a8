"""Per cent of the MLP backward's roofline in a train iteration: twice the
forward's work (input and weight gradients) at the dtype's peak, or its
bytes at HBM bandwidth, over the device time of the kernels the mlp_bwd map
names."""

from perfbench import readers


def read(r):
    return readers.roofline(r, "mlp_bwd")
