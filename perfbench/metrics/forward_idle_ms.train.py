"""Device-idle ms an iteration in the forward: the traced slice's gaps
(between the union of its device operations) whose middle falls inside a
`train.forward` span of the program."""

from perfbench import program_spans


def read(r):
    return program_spans.idle_ms(r.trace, "train.forward")
