"""The whole step's share of the card's peak: 3 x the scene MLPs' forward FLOP
of every iteration in the window (recomputation not counted), over the
window's seconds, per cent of the configuration dtype's peak."""

from perfbench import readers


def read(r):
    return readers.mfu(r)
