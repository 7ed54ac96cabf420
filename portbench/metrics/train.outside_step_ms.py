"""Host ms per iteration outside the train step: pctrans.train.iteration less pctrans.train.step (loader, monitor, the loop's checks)."""

from portbench import program_spans


def read(run):
    return program_spans.train_outside_ms()
