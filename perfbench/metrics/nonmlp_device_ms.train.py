"""Device ms an iteration outside the MLP kernel maps (kernels/*.json roles
mlp_fwd and mlp_bwd): RBK, sampling, compositing, SND, tone map, loss, Adam;
from the traced slice."""

from perfbench import readers


def read(r):
    return readers.nonmlp_device_ms(r)
