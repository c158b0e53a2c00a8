"""Device ms a view outside the MLP kernel maps: rays, sampling, compositing,
the SND head, tone map, the copy to the host; from the traced slice."""

from perfbench import readers


def read(r):
    return readers.nonmlp_device_ms(r)
