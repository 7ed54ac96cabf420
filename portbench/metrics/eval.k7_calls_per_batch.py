"""Calls of K7 (the masks' statistics, pctrans_torch/ops/mask_stats.py)
per eval batch: counter mask_stats_kernel inside the eval spans over the
traced batches, one per eval.dispatch span; one per forward (the TOP_K
dispatch and the full-Q re-run) and, in the CVPPP protocol, one more for
the merged masks, where K7 serves them all.  None for a program that keeps
no such counter, or where nothing was traced."""

from portbench import program_spans


def read(run):
    try:
        from pctrans_torch.utils import tracing
    except ImportError:
        return None
    if "mask_stats_kernel" not in getattr(tracing, "COUNTERS", ()):
        return None
    t = program_spans.table()
    batches = sum(1 for r in t["spans"] if r.name == "eval.dispatch") if t else 0
    if not batches:
        return None
    return sum(n for name, path, _, n in t["counts"]
               if name == "mask_stats_kernel" and path[0].startswith("eval.")) / batches
