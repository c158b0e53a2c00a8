"""Host ms a view of the rematch's encoder passes (the program's
`dkm.encode`, which ends on a sync).  The driver runs the encoder once on
one view before the rematch, outside the span, so these are warm passes,
as a run's later rematches make them (a process's first convolutions took
~40 ms more a view)."""


def read(r):
    s, views = r.setup["spans_s"].get("dkm.encode"), r.setup["counts"].get("rematch.views")
    return None if s is None or not views else 1e3 * s / views
