"""Host ms an iteration inside the program's `sync.*` spans in the traced
slice: the host waiting for the device's queue to drain."""

from perfbench import program_spans


def read(r):
    return program_spans.host_ms(r.trace, "sync.")
