"""Calls of K8 (the scored images' label-pair tables,
pctrans_torch/ops/label_pairs.py) per eval batch: counter label_pairs_kernel
inside the eval spans over the traced batches, one per eval.dispatch span;
one per batch where K8 builds every scored batch's tables beside the paint.
None for a program that keeps no such counter, or where nothing was
traced."""

from portbench import program_spans


def read(run):
    try:
        from pctrans_torch.utils import tracing
    except ImportError:
        return None
    if "label_pairs_kernel" not in getattr(tracing, "COUNTERS", ()):
        return None
    t = program_spans.table()
    batches = sum(1 for r in t["spans"] if r.name == "eval.dispatch") if t else 0
    if not batches:
        return None
    return sum(n for name, path, _, n in t["counts"]
               if name == "label_pairs_kernel" and path[0].startswith("eval.")) / batches
