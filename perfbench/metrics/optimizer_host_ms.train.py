"""Host ms an iteration in the program's `train.optimizer` spans (the
grads' zero-fill, all-reduce and clip, Adam's and the scheduler's step)
over the traced slice."""

from perfbench import program_spans


def read(r):
    return program_spans.host_ms(r.trace, "train.optimizer")
