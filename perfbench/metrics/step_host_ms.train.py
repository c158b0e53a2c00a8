"""Host ms an iteration inside trainer.train_step (forward, backward, Adam):
the benchmark's spans around it over the window, over the iterations."""

from perfbench import readers


def read(r):
    return readers.host_ms_per_unit(r, "train_step")
