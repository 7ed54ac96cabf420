"""Host ms per iteration in the backward (span pctrans.step.backward)."""

from portbench import program_spans


def read(run):
    return program_spans.train_ms("step.backward")
