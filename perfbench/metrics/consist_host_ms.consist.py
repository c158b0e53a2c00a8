"""Host ms an iteration in the program's `train.consist` spans (the aligned
render and the CTE loss inside `loss_fn`) over the untraced window."""

from perfbench import readers


def read(r):
    return readers.host_ms_per_unit(r, "train.consist")
