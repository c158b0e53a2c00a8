"""The whole view's share of the card's peak: the scene MLPs' forward FLOP of
every view in the window over the window's seconds, per cent of the
configuration dtype's peak."""

from perfbench import readers


def read(r):
    return readers.mfu(r)
