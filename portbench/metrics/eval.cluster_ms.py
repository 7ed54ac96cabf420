"""Host ms per batch in the label pipeline's cluster stage (span pctrans.eval.cluster, the full-Q re-run included)."""

from portbench import program_spans


def read(run):
    return program_spans.eval_stage_ms("eval.cluster")
