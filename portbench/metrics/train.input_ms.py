"""Host ms per iteration in the train step's input phase (span pctrans.step.input: widen, copy to the card, targets, draws)."""

from portbench import program_spans


def read(run):
    return program_spans.train_ms("step.input")
