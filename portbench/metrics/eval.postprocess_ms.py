"""Host ms per batch in DevicePostprocessor.start and finish."""

from portbench import readers


def read(run):
    return readers.per(run, "postprocess", "batches")
