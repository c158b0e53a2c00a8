"""Host ms an untraced iteration inside Trainer.train but outside train_step
(the batch draw, the stage, the cadence checks and their prints): the
program's `train.iteration` spans less its `train.step` spans, recorded
over the window, over the iterations."""


def read(r):
    it, step = r.spans_s.get("train.iteration"), r.spans_s.get("train.step")
    if it is None or step is None or r.units == 0:
        return None
    return 1e3 * (it - step) / r.units
