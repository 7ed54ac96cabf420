"""Spans and counters inside the port: where the host's time goes in the
train step, the Trainer's loop and the eval label pipeline.

Off by default.  Off, a span site costs one check of two module flags and
returns a shared no-op context: no clock read, no ``record_function``, no
allocation.  Tracing is on while :func:`enable` is in force or a
``torch.profiler`` window is open in the process (the monitor's
``MONITOR.PROFILE_ITERS`` window, or a benchmark's traced window), so an
untraced run measures the off path.  On, ``span(name, key)``

* opens ``torch.profiler.record_function("pctrans.<name>")``, so that the
  span and the card's kernels share the profiler's clock in an open trace;
* appends a :class:`Record` to an in-memory table, on the host clock of
  ``time.perf_counter_ns``: the enclosing span's name (``parent``), the
  ``key`` (the iteration, or the eval batch; inherited from the enclosing
  span unless given) and the span's self time (its duration less the part
  its child spans cover).

``count(name, n)`` adds ``n`` to a counter of the innermost open span,
kept by that span's path of names and its key.  ``host_syncs`` counts the
host-device syncs inside spans: a wait on a CUDA event counts itself where
the program makes it, and every other sync (a pageable copy, ``.item()``,
an op that reads the card) is counted from the warning of PyTorch's sync
debug mode, which is on while a span is open on a CUDA machine.

``COUNTERS`` names every counter the program keeps: ``host_syncs``; the
eval forward's CUDA graphs (``models/graphs.py``): ``graph_captures``,
one per input shape captured, and ``graph_replays``, one per forward a
replay served; ``window_attn_kernel``, one per launch of Swin's fused
window attention (K6, ``ops/window_attn.py``); ``mask_stats_kernel``,
one per launch of the masks' statistics (K7, ``ops/mask_stats.py``); and
``label_pairs_kernel``, one per launch of the scored images' label-pair
tables (K8, ``ops/label_pairs.py``).

Spans are opened from one thread, the loop's.  A counter from another
thread goes to the innermost open span: autograd's device threads run the
backward while the loop's thread waits in it.  A span inside which a
profiler window may open or close (``ranged=False``: the train loop's
iteration, whose step a caller may wrap) keeps its record and opens no
profiler range: a range open while one profiler stops and the next starts
would end in the second with its event in the first's freed storage.
"""

from __future__ import annotations

import re
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "pctrans."
COUNTERS = ("host_syncs", "graph_captures", "graph_replays", "window_attn_kernel",
            "mask_stats_kernel", "label_pairs_kernel")
SYNC_WARNING = "called a synchronizing CUDA operation"
PROTOTYPE_WARNING = "Synchronization debug mode is a prototype"   # at each mode change


class Record(NamedTuple):
    name: str
    parent: Optional[str]
    key: Optional[int]
    t0_ns: int
    t1_ns: int
    self_ns: int


_enabled = False
_records: List[Record] = []
_counts: Dict[Tuple[str, Tuple[str, ...], Optional[int]], int] = {}
_stack: List["_Span"] = []
_cuda: Optional[bool] = None          # whether the sync debug mode can count
_sync_mode = 0                        # the mode to restore after the outermost span
_show = None                          # warnings.showwarning under the sync hook
_SYNC_FILTER = ("always", re.compile(SYNC_WARNING, re.I), Warning, None, 0)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "key", "ranged", "parent", "path", "child_ns", "rf", "t0")

    def __init__(self, name: str, key: Optional[int], ranged: bool):
        self.name, self.key, self.ranged = name, key, ranged

    def __enter__(self):
        if _stack:
            outer = _stack[-1]
            self.parent, self.path = outer.name, outer.path + (self.name,)
            if self.key is None:
                self.key = outer.key
        else:
            self.parent, self.path = None, (self.name,)
            _count_syncs(True)
        self.child_ns = 0
        self.rf = _profiler.record_function(PREFIX + self.name) if self.ranged else None
        if self.rf is not None:
            self.rf.__enter__()
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        d = t1 - self.t0
        _records.append(Record(self.name, self.parent, self.key, self.t0, t1,
                               d - self.child_ns))
        if _stack:
            _stack[-1].child_ns += d
        else:
            _count_syncs(False)
        return False


def span(name: str, key: Optional[int] = None, ranged: bool = True):
    """A context manager: span ``pctrans.<name>`` while tracing is on, else
    a shared no-op; ``ranged=False`` records it without a profiler range."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name, key, ranged)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (nothing
    outside spans)."""
    if _stack:
        top = _stack[-1]
        k = (name, top.path, top.key)
        _counts[k] = _counts.get(k, 0) + n


def _show_warning(message, category, filename, lineno, file=None, line=None):
    text = str(message)
    if _stack and text.startswith(SYNC_WARNING):
        count("host_syncs")
        return
    if text.startswith(PROTOTYPE_WARNING):
        return
    _show(message, category, filename, lineno, file, line)


def _count_syncs(on: bool) -> None:
    """Around the outermost span: PyTorch's sync debug mode warns at each
    implicit sync, and the warning is counted instead of shown."""
    global _cuda, _show, _sync_mode
    if _cuda is None:
        _cuda = torch.cuda.is_available()
    if on:
        if warnings.showwarning is not _show_warning:
            _show, warnings.showwarning = warnings.showwarning, _show_warning
        if _SYNC_FILTER not in warnings.filters:
            warnings.filterwarnings("always", message=SYNC_WARNING)
        if _cuda:
            _sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(1)
    elif _cuda:
        torch.cuda.set_sync_debug_mode(_sync_mode)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Empty the table (the spans still open are kept and recorded)."""
    _records.clear()
    _counts.clear()


def table() -> dict:
    """``{"spans": [Record, ...] in the order they closed, "counts":
    [(counter, path of span names, key, n), ...]}``."""
    return {"spans": list(_records),
            "counts": [(name, path, key, n) for (name, path, key), n in _counts.items()]}
