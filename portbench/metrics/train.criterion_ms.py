"""Host ms per iteration in the criterion (span pctrans.step.criterion, the matcher included)."""

from portbench import program_spans


def read(run):
    return program_spans.train_ms("step.criterion")
