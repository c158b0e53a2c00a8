"""Host ms an iteration inside Trainer.train but outside train_step (the batch
draw, the stage, the cadence checks and their prints): the window's time in
the benchmark's spans around Trainer.train less its spans around
trainer.train_step, over the iterations."""

from perfbench import readers


def read(r):
    return readers.host_ms_per_unit(r, "trainer_loop")
