"""Forwards the evaluator ran per batch of the window (Evaluator.forwards): 2 where TOP_K was
lossy and the batch ran again at full Q."""


def read(run):
    batches = run.counters.get("batches")
    return run.counters["forwards"] / batches if batches else None
