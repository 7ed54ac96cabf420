"""Host ms per iteration in the train step's forward (span pctrans.step.forward)."""

from portbench import program_spans


def read(run):
    return program_spans.train_ms("step.forward")
