"""Device-idle ms an iteration in the backward: the traced slice's gaps
whose middle falls inside a `train.backward` span of the program (the
backward's work on autograd's device thread lies inside it in time)."""

from perfbench import program_spans


def read(r):
    return program_spans.idle_ms(r.trace, "train.backward")
