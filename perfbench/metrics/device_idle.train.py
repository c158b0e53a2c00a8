"""Per cent of an untraced train iteration in which no operation ran on the
device: 1 - (the traced slice's busy time an iteration, the union of its
device operations) / (the window's seconds an iteration).  See
readers.device_idle for why the slice's own span is not the denominator."""

from perfbench import readers


def read(r):
    return readers.device_idle(r)
