"""Calls of K6 (Swin's fused window attention) per eval forward: counter
window_attn_kernel inside the eval spans over the forwards of the same
traced batches, one per eval.dispatch span and one per eval.rerun span;
one per Swin block where K6 serves them all.  None for a program that keeps
no such counter, or where nothing was traced."""

from portbench import program_spans

FORWARD_SPANS = ("eval.dispatch", "eval.rerun")


def read(run):
    try:
        from pctrans_torch.utils import tracing
    except ImportError:
        return None
    if "window_attn_kernel" not in getattr(tracing, "COUNTERS", ()):
        return None
    t = program_spans.table()
    forwards = sum(1 for r in t["spans"] if r.name in FORWARD_SPANS) if t else 0
    if not forwards:
        return None
    return sum(n for name, path, _, n in t["counts"]
               if name == "window_attn_kernel" and path[0].startswith("eval.")) / forwards
