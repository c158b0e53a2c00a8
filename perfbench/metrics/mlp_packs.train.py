"""Weight packs an iteration of the fused MLP (the program's `mlp.pack`
spans in the traced slice, one a pack built, none on a cache hit): the f32
forward and backward blobs of both scene MLPs after each Adam step."""

from perfbench import program_spans


def read(r):
    return program_spans.count(r.trace, "mlp.pack")
