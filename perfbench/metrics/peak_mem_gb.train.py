"""max_memory_allocated over the window (reset at its start; the ray dataset
stays resident), in GB."""

from perfbench import readers


def read(r):
    return readers.peak_gb(r)
