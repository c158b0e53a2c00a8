"""Host seconds of the rematch's renders, gathered to the host (the
program's `rematch.render`)."""


def read(r):
    return r.setup["spans_s"].get("rematch.render")
