"""The port's own ranges in a traced window: what the program's spans
(``pctrans.*`` ``record_function`` ranges, ``pctrans_torch/utils/
tracing.py``) show of the card's work and idle time.

:func:`analyse` reads the Chrome trace events that ``trace.analyse`` reads
and gives two keys that it does not:

* ``program_ranges``: per range name, how many there were, their host
  seconds, the device seconds of the kernels, copies and sets launched
  inside them, their launches,
  its synchronizing runtime calls (``cudaStreamSynchronize``,
  ``cudaEventSynchronize``, ``cudaDeviceSynchronize``, blocking
  ``cudaMemcpy*``) and its costliest device operations launched with it
  the innermost range.  A launch or call belongs to every range open on its
  thread when it is made; where no range is open on its thread (autograd
  launches the backward from a thread of its own while the loop's thread
  waits in ``backward``), to every range open then on any thread.  Nested
  ranges each hold their children's work.
* ``program_gaps``: the card's idle time, window edges included, by the
  innermost range open on the loop's thread (the one that opened the most
  ranges) when each gap began; ``outside`` where none was open.  With the
  busy time it sums to ``events_span_s``, from the first to the last host
  operation, runtime call or device event (a range open when the window
  opened or closed keeps its own times, which lie outside the window).

``trace.analyse`` and what its readers return stay as they are; adding
these keys to it, and per-layer readers of them, is left to a benchmark
change.  Until then one traced run of a cell with them is

    python3 -m portbench.program_trace --workload NAME --seed N --seconds S --trace 1

which runs ``portbench.run`` with this analysis beside ``trace.analyse``
on each traced window and prints the host window's as a JSON line after the
result line.  ``--spans-on`` (with ``--trace 0``) keeps the program's spans
on through the run, and prints the program's per-layer readings over the
whole measured window after the result line: the cost of tracing against
an untraced run, and the spans of every iteration or batch.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Dict, List

from .trace import DEVICE_CATS, LAUNCH_CATS, LAUNCH_NAMES, _merge

PREFIX = "pctrans."
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")
TOP_OPS = 3


def is_sync(name: str) -> bool:
    return name in SYNC_CALLS or (name.startswith("cudaMemcpy") and not name.endswith("Async"))


def analyse(events: List[dict]) -> dict:
    device, launches, syncs, spans = [], {}, [], []
    first, last = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, name, cat = float(e["ts"]), str(e.get("name", "")), e.get("cat")
        if cat in DEVICE_CATS or cat in LAUNCH_CATS or cat == "cpu_op":
            first, last = min(first, ts), max(last, ts + float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if any(k in name for k in LAUNCH_NAMES) and corr is not None:
                launches[corr] = (e["tid"], ts)
            if is_sync(name):
                syncs.append((e["tid"], ts))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((ts, ts + float(e["dur"]), e["tid"], name[len(PREFIX):]))
    per_tid = defaultdict(int)
    for s in spans:
        per_tid[s[2]] += 1
    loop = max(per_tid, key=per_tid.get) if per_tid else None
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), None)
                   for e in device])

    # one sweep in time: ranges open and close; launches, syncs and gap
    # starts take the ranges open at their time (a close at t comes first)
    points = []
    for i, (s, end, tid, name) in enumerate(spans):
        points += [(s, 1, i), (end, 0, i)]
    points += [(ts, 2, ("launch", corr, tid)) for corr, (tid, ts) in launches.items()]
    points += [(ts, 2, ("sync", None, tid)) for tid, ts in syncs]
    gap_starts = ([(first, busy[0][0])] if busy else []) + \
        [(e0, s1) for (_, e0, _), (s1, _, _) in zip(busy, busy[1:])] + \
        ([(busy[-1][1], last)] if busy else [(first, last)] if last > first else [])
    points += [(g0, 2, ("gap", g1 - g0, loop)) for g0, g1 in gap_starts]
    points.sort(key=lambda p: (p[0], p[1]))

    ranges: Dict[str, dict] = {}
    for s, end, _, name in spans:
        r = ranges.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                     "launches": 0, "syncs": 0, "ops": defaultdict(float)})
        r["count"] += 1
        r["host_s"] += (end - s) * 1e-6
    open_by_tid: Dict[object, Dict[int, tuple]] = defaultdict(dict)
    owner = {}                     # launch correlation -> (range names, innermost)
    gaps = defaultdict(float)
    for t, kind, x in points:
        if kind == 1:
            open_by_tid[spans[x][2]][x] = spans[x]
            continue
        if kind == 0:
            open_by_tid[spans[x][2]].pop(x, None)
            continue
        what, arg, tid = x
        if what == "gap":
            here = open_by_tid.get(tid) or {}
            gaps[max(here.values())[3] if here else "outside"] += arg * 1e-6
            continue
        here = open_by_tid.get(tid) or {i: s for d in open_by_tid.values()
                                        for i, s in d.items()}
        if not here:
            continue
        names = {s[3] for s in here.values()}
        if what == "sync":
            for n in names:
                ranges[n]["syncs"] += 1
        else:
            owner[arg] = (names, max(here.values())[3])
            for n in names:
                ranges[n]["launches"] += 1
    for e in device:
        site = owner.get(e.get("args", {}).get("correlation"))
        if site is None:
            continue
        dur = float(e.get("dur", 0.0)) * 1e-6
        for n in site[0]:
            ranges[n]["device_s"] += dur
        ranges[site[1]]["ops"][e["name"][:120]] += dur
    for r in ranges.values():
        r["ops"] = sorted(([n, s] for n, s in r["ops"].items()), key=lambda x: -x[1])[:TOP_OPS]
    return {"program_ranges": ranges,
            "program_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1]),
            "events_span_s": max(last - first, 0.0) * 1e-6,
            "busy_s": sum(e - s for s, e, _ in busy) * 1e-6}


def main(argv=None) -> int:
    from . import run, timing, trace

    argv = list(sys.argv[1:] if argv is None else argv)
    spans_on = "--spans-on" in argv
    if spans_on:
        argv.remove("--spans-on")
    found = []
    analyse_window = trace.analyse

    def both(events, window_s):
        found.append({**analyse(events), "window_s": window_s})
        return analyse_window(events, window_s)

    trace.analyse = both
    if spans_on:
        from pctrans_torch.utils import tracing

        tracing.enable()
        clock_reset = timing.Clock.reset

        def reset(clock):              # the window starts: the spans start with it
            tracing.reset()
            clock_reset(clock)
        timing.Clock.reset = reset
    rc = run.main(argv)
    if spans_on:
        from pctrans_torch.utils import tracing

        tracing.disable()
        print(json.dumps({"program_spans": readings()}), flush=True)
    if found:
        print(json.dumps({"program_trace": found[-1]}), flush=True)
    return rc


def readings() -> dict:
    """Every reader of the program's spans, on the table as it stands."""
    from . import bench

    out = {}
    for m in bench.manifest()["per_layer"]:
        mod = bench.load_module("metrics", m["name"])
        if hasattr(mod, "program_spans"):
            value = mod.read(None)
            if value is not None:
                out[m["name"]] = value
    return out


if __name__ == "__main__":
    sys.exit(main())
