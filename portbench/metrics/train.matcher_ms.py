"""Host ms per step in match_padded: the cost matrix's copy to the host (which waits for the forward) and scipy's LAP."""

from portbench import readers


def read(run):
    return readers.per(run, "matcher", "iterations")
