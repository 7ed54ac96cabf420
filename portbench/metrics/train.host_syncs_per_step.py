"""Host-device syncs per train step: counter host_syncs inside pctrans.train.step."""

from portbench import program_spans


def read(run):
    return program_spans.train_syncs_per_step()
