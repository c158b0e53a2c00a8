"""Host ms an ordered pair of the rematch's decoder calls and their tables'
copies to the host (the program's `dkm.decode`)."""


def read(r):
    s, pairs = r.setup["spans_s"].get("dkm.decode"), r.setup["counts"].get("rematch.pairs")
    return None if s is None or not pairs else 1e3 * s / pairs
