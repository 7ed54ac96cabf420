"""Host ms per iteration waiting for the card: the self time of the pctrans.wait.* spans."""

from portbench import program_spans


def read(run):
    return program_spans.train_wait_ms()
