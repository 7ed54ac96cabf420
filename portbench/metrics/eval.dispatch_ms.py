"""Host ms per batch in the label pipeline's dispatch stage (span pctrans.eval.dispatch: the forward, TOP_K, K4 and statistics queued)."""

from portbench import program_spans


def read(run):
    return program_spans.eval_stage_ms("eval.dispatch")
