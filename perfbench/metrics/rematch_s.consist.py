"""Host seconds of the set-up's rematch (the program's `train.rematch`):
the train views' renders and every ordered pair's match."""


def read(r):
    return r.setup["spans_s"].get("train.rematch")
