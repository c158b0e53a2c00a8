"""Host ms an iteration in the program's `train.backward` spans
(loss.backward() inside train_step) over the traced slice; read above an
untraced iteration's, as forward_host_ms.train."""

from perfbench import program_spans


def read(r):
    return program_spans.host_ms(r.trace, "train.backward")
