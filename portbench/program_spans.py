"""The port's own spans (``pctrans_torch/utils/tracing.py``) as the
per-layer readers see them.

The program records its spans while a ``torch.profiler`` window is open
in the process, so in a ``--trace 1`` run its table holds the spans of the
traced windows (the card-only one and the host one, and any set aside):
the warm-up, the untraced rest of the window and the reference's check run
with no profiler open.  Train numbers are per iteration over the
iterations whose ``train.iteration`` and ``train.step`` spans both lie in
a window; eval numbers per batch over the batches dispatched in one.  A
program without the tracing module, or a table with nothing to read,
gives None.
"""

from __future__ import annotations

from typing import Dict, Optional

def table() -> Optional[dict]:
    try:
        from pctrans_torch.utils import tracing
    except ImportError:
        return None
    t = tracing.table()
    return t if t["spans"] else None


def _ms(r) -> float:
    return (r.t1_ns - r.t0_ns) / 1e6


def iterations(t: dict) -> Dict[int, list]:
    """Iteration -> its spans, for the iterations whose ``train.iteration``
    and ``train.step`` spans are both in the table."""
    by: Dict[int, list] = {}
    for r in t["spans"]:
        if r.key is not None:
            by.setdefault(r.key, []).append(r)
    return {k: rs for k, rs in by.items()
            if {"train.iteration", "train.step"} <= {r.name for r in rs}}


def _whole():
    """(the table, its whole iterations), or (None, {}) with nothing to read."""
    t = table()
    its = iterations(t) if t else {}
    return (t, its) if its else (None, {})


def train_ms(*names: str) -> Optional[float]:
    """Host ms per iteration in the spans ``names``."""
    _, its = _whole()
    if not its:
        return None
    return sum(_ms(r) for rs in its.values() for r in rs if r.name in names) / len(its)


def train_outside_ms() -> Optional[float]:
    """Host ms per iteration in the Trainer's spans outside the step: the
    children of ``train.iteration`` but ``train.step`` (``train.loader``,
    ``train.monitor``, and SWA, validation and checkpoints when they run).
    The iteration's self time is left out: the loop's own bookkeeping, and
    in a benchmark run the harness's wrapper of the step, which opens,
    reads and closes the traced windows."""
    _, its = _whole()
    if not its:
        return None
    return sum(_ms(r) for rs in its.values() for r in rs
               if r.parent == "train.iteration" and r.name != "train.step") / len(its)


def train_wait_ms() -> Optional[float]:
    """Host ms per iteration waiting for the card: the ``wait.*`` spans'
    self time (a wait inside another counts once)."""
    _, its = _whole()
    if not its:
        return None
    return sum(r.self_ns for rs in its.values() for r in rs
               if r.name.startswith("wait.")) / 1e6 / len(its)


def train_syncs_per_step() -> Optional[float]:
    """``host_syncs`` counted inside ``train.step``, per step."""
    t, its = _whole()
    if not its:
        return None
    return sum(n for name, path, key, n in t["counts"]
               if name == "host_syncs" and key in its and "train.step" in path) / len(its)


def _batches(t: dict) -> int:
    return sum(1 for r in t["spans"] if r.name == "eval.dispatch")


def eval_stage_ms(name: str) -> Optional[float]:
    """Host ms per batch in stage span ``name`` (its children included)."""
    t = table()
    xs = [_ms(r) for r in t["spans"] if r.name == name] if t else []
    return sum(xs) / len(xs) if xs else None


def eval_pipeline_wait_ms() -> Optional[float]:
    """Per batch, its time queued in the label pipeline: from its
    ``eval.dispatch`` start to its ``eval.collect`` end, the time the
    program spent in the other batches' stages and in the scoring; the
    mean over the batches with both spans in the table.  Time in no
    program span (in a benchmark run the harness's pulls and its traced
    windows' reading) is left out."""
    t = table()
    if not t:
        return None
    top = [r for r in t["spans"] if r.parent is None and r.name.startswith("eval.")]
    ends = {}
    for r in top:
        if r.name in ("eval.dispatch", "eval.collect"):
            ends.setdefault(r.key, {})[r.name] = r
    waits = []
    for k, e in ends.items():
        if len(e) == 2:
            t0, t1 = e["eval.dispatch"].t0_ns, e["eval.collect"].t1_ns
            waits.append(sum(max(0, min(r.t1_ns, t1) - max(r.t0_ns, t0)) for r in top
                             if r.key != k or r.name == "eval.score") / 1e6)
    return sum(waits) / len(waits) if waits else None


def eval_wait_ms() -> Optional[float]:
    """Host ms per batch waiting for the card in the label pipeline and the
    scoring: the ``wait.*`` spans' self time over the batches dispatched."""
    t = table()
    n = _batches(t) if t else 0
    if not n:
        return None
    return sum(r.self_ns for r in t["spans"] if r.name.startswith("wait.")) / 1e6 / n


def eval_syncs_per_batch() -> Optional[float]:
    """``host_syncs`` counted inside the eval spans, per batch dispatched."""
    t = table()
    n = _batches(t) if t else 0
    if not n:
        return None
    return sum(c for name, path, key, c in t["counts"]
               if name == "host_syncs" and path[0].startswith("eval.")) / n
