"""Per cent of an untraced rendered view in which no operation ran on the
device: 1 - (the traced slice's busy time a view) / (the window's seconds a
view), as device_idle.train reads it."""

from perfbench import readers


def read(r):
    return readers.device_idle(r)
