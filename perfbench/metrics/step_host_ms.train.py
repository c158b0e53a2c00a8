"""Host ms an untraced iteration inside train_step (forward, backward, Adam):
the program's `train.step` spans, recorded over the window, over the
iterations."""

from perfbench import readers


def read(r):
    return readers.host_ms_per_unit(r, "train.step")
