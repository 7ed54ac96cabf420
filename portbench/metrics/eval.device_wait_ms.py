"""Host ms per batch waiting for the card: the self time of the pctrans.wait.* spans."""

from portbench import program_spans


def read(run):
    return program_spans.eval_wait_ms()
