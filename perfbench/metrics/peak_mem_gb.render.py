"""max_memory_allocated over the window (reset at its start), in GB."""

from perfbench import readers


def read(r):
    return readers.peak_gb(r)
