"""Host ms per batch queued in the label pipeline: its dispatch start to its collect end, less its own stage spans."""

from portbench import program_spans


def read(run):
    return program_spans.eval_pipeline_wait_ms()
