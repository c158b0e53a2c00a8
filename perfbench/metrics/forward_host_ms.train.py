"""Host ms an iteration in the program's `train.forward` spans (the loss_fn
call inside train_step) over the traced slice; the profiler's ~10 us a
device operation makes it read above an untraced iteration's."""

from perfbench import program_spans


def read(r):
    return program_spans.host_ms(r.trace, "train.forward")
