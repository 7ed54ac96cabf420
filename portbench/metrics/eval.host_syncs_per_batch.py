"""Host-device syncs per batch: counter host_syncs inside the eval spans."""

from portbench import program_spans


def read(run):
    return program_spans.eval_syncs_per_batch()
