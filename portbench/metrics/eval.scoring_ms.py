"""Host ms per batch from the label pipeline yielding it to the protocol asking for the next: the scoring loop."""

from portbench import readers


def read(run):
    return readers.per(run, "scoring", "batches")
