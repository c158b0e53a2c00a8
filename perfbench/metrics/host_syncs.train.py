"""Device-to-host syncs an iteration: the program's `sync.*` spans in the
traced slice, one around each sync on the train path (the f32 weight
packs' range checks, cumprod's backward, the log's reads)."""

from perfbench import program_spans


def read(r):
    return program_spans.count(r.trace, "sync.")
