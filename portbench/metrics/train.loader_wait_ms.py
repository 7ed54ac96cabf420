"""Host ms per iteration in next() on the Trainer's train loader."""

from portbench import readers


def read(run):
    return readers.per(run, "loader_wait", "iterations")
