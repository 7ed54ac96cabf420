"""Host ms per iteration in the gradient exchange and the optimizer (spans pctrans.step.allreduce and pctrans.step.optimizer)."""

from portbench import program_spans


def read(run):
    return program_spans.train_ms("step.allreduce", "step.optimizer")
