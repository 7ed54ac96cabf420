"""The traced window of a ``--trace 1`` run and what it reads.

The window opens at one iteration (or batch) of the measured loop and
closes some iterations later (:class:`TraceWindow`).  ``torch.profiler``
traces CPU and CUDA activity there, and the Chrome trace it exports is read
in :func:`analyse`:

* ``busy_s``: the union of the device's kernel, copy and set intervals;
  ``window_s``: the host clock from the profiler's start to its stop, after
  a synchronise;
* per ``portbench.*`` range (``record_function`` ranges the harness puts
  around the program's calls): the device seconds of every kernel launched
  inside it, found through the launch's correlation id and its thread, and
  the number of ranges;
* the device operations that took most time, and the idle gaps by what the
  host was doing (the innermost ``portbench.*`` range and CPU operation, at
  the gap's start, of the thread that launched the work ending the gap).

A trace can lose events on the H100, in bursts (``chip_smoke.py``'s
``trace_kernels``): a window whose launches lost more than 1% of their
device events, or with a kernel range that holds no device time, is set
aside and taken again at a later iteration after a pause that doubles from
0.1 s, at most ``TRACE_TRIES`` times; then the fullest is used.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import List, Optional

import torch

from .timing import TRACE_TRIES

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_NAMES = ("LaunchKernel", "Memcpy", "Memset")   # the calls that put work on the device
KERNEL_RANGES = ("portbench.k1", "portbench.k2", "portbench.k3", "portbench.k4")
TOP = 10


class TraceWindow:
    """Opens the profiler at iteration ``start`` of a loop that calls
    :meth:`tick` once per iteration, closes it ``length`` iterations later,
    and keeps the analysis; a set-aside window is taken again from the next
    iteration, up to ``TRACE_TRIES`` windows in all."""

    def __init__(self, start: int, length: int, path: str, ranges_expected=(),
                 on_open=None, device="cuda", host: bool = True):
        self.start, self.length, self.path = int(start), int(length), path
        self.ranges_expected = tuple(ranges_expected)
        self.on_open = on_open
        self.cuda = torch.device(device).type == "cuda"
        self.host = host or not self.cuda       # trace the host's operations too
        self.overhead_s = 0.0
        self.tries = 0
        self.set_aside: List[str] = []
        self.result: Optional[dict] = None
        self._fullest: Optional[dict] = None
        self._prof = None
        self._opened_at = 0
        self._t0 = 0.0

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def is_open(self) -> bool:
        return self._prof is not None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def tick(self, iteration: int) -> None:
        """Call before iteration ``iteration`` runs."""
        if self.done:
            return
        if self._prof is None and iteration >= self.start:
            from torch.profiler import ProfilerActivity, profile

            t0 = time.perf_counter()
            if self.tries:
                time.sleep(0.05 * 2 ** self.tries)
            self._sync()
            activities = [ProfilerActivity.CPU] if self.host else []
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            if self.on_open is not None:
                self.on_open()
            self._prof.start()
            self._opened_at = iteration
            self._t0 = time.perf_counter()
            self.overhead_s += self._t0 - t0
        elif self._prof is not None and iteration >= self._opened_at + self.length:
            self.close()

    def close(self) -> None:
        """Close an open window (also at the end of the loop) and read it."""
        if self._prof is None:
            return
        self._sync()
        t_close = time.perf_counter()
        window_s = t_close - self._t0
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        res = analyse(events, window_s)
        self.overhead_s += time.perf_counter() - t_close
        self.tries += 1
        why = why_again(res, self.ranges_expected)
        if why is None:
            self.result = res
            return
        self.set_aside.append(why)
        print(f"trace {self.tries} of at most {TRACE_TRIES} set aside: {why}")
        if self._fullest is None or res["device_events"] > self._fullest["device_events"]:
            self._fullest = res
        if self.tries >= TRACE_TRIES:
            print(f"using the fullest of {TRACE_TRIES} traces")
            self.result = self._fullest
        else:
            self.start = self._opened_at + self.length

    def finish(self) -> Optional[dict]:
        """At the end of the loop: close what is open; the reading, or the
        fullest set-aside one, or None when no window was ever opened."""
        self.close()
        if self.result is None and self._fullest is not None:
            self.result = self._fullest
        return self.result


def why_again(res: dict, ranges_expected) -> Optional[str]:
    if not res["device_events"]:
        return "it holds no device event"
    if res["launches"] and res["launches_lost"] > 0.01 * res["launches"]:
        return (f"{res['launches_lost']} of {res['launches']} launches have no "
                "device event")
    for name in ranges_expected:
        r = res["ranges"].get(name)
        if not r or r["device_s"] <= 0 or r["empty"]:
            return f"{name}: {r['empty'] if r else 'all'} ranges hold no device event"
    return None


def _merge(intervals):
    """Busy intervals [start, end, the launch site of their first work]."""
    merged = []
    for s, e, site in sorted(intervals, key=lambda x: (x[0], x[1])):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e, site])
    return merged


class _Stack:
    """Intervals of one thread, for the innermost one holding a time."""

    def __init__(self, spans):
        self.spans = sorted(spans)                 # (ts, end, name)
        self.starts = [s[0] for s in self.spans]

    def innermost(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t)
        best = None
        for s, e, name in reversed(self.spans[max(0, i - 512):i]):
            if s <= t < e and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else None


def analyse(events: List[dict], window_s: float) -> dict:
    device, launches = [], {}
    ranges = defaultdict(list)          # tid -> [(ts, end, name)] of portbench ranges
    ops = defaultdict(list)             # tid -> [(ts, end, name)] of CPU ops
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS and any(k in e.get("name", "") for k in LAUNCH_NAMES):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], float(e["ts"]))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith("portbench."):
            ranges[e["tid"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                     e["name"]))
        elif cat == "cpu_op":
            ops[e["tid"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                  e["name"]))
    range_stacks = {tid: _Stack(v) for tid, v in ranges.items()}
    op_stacks = {tid: _Stack(v) for tid, v in ops.items()}

    by_range = {}
    for spans in ranges.values():
        for _, _, name in spans:
            r = by_range.setdefault(name, {"count": 0, "device_s": 0.0, "empty": 0,
                                           "_hit": set()})
            r["count"] += 1
    by_op = defaultdict(float)
    intervals, matched = [], 0
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = e.get("args", {}).get("correlation")
        site = launches.get(corr)
        intervals.append((ts, ts + dur, site))
        by_op[e["name"]] += dur * 1e-6
        if site is None:
            continue
        matched += 1
        tid, t_launch = site
        stack = range_stacks.get(tid)
        span = None
        if stack is not None:
            i = bisect.bisect_right(stack.starts, t_launch)
            for s, end, name in reversed(stack.spans[max(0, i - 512):i]):
                if s <= t_launch < end and name in KERNEL_RANGES:
                    span = (s, name)
                    break
        if span is not None:
            r = by_range[span[1]]
            r["device_s"] += dur * 1e-6
            r["_hit"].add(span[0])
    for name, r in by_range.items():
        r["empty"] = r["count"] - len(r.pop("_hit")) if name in KERNEL_RANGES else 0

    merged = _merge(intervals)
    busy = sum(e - s for s, e, _ in merged)
    # an idle gap is named by what the thread that launched the work ending
    # it was doing when it began: its innermost portbench range and CPU op
    gaps = defaultdict(float)
    for (_, e0, _), (s1, _, site) in zip(merged, merged[1:]):
        label = "host"
        if site is not None:
            tid = site[0]
            span = range_stacks[tid].innermost(e0) if tid in range_stacks else None
            op = op_stacks[tid].innermost(e0) if tid in op_stacks else None
            label = ": ".join(x for x in (span, op) if x) or "host"
        gaps[label] += (s1 - e0) * 1e-6
    return {
        "busy_s": busy * 1e-6,
        "window_s": window_s,
        "device_events": len(device),
        "launches": len(launches),
        "launches_lost": max(len(launches) - matched, 0),
        "ranges": by_range,
        "device_ops": sorted(([n[:120], s] for n, s in by_op.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([n[:120], s] for n, s in gaps.items()),
                            key=lambda x: -x[1])[:TOP],
    }


class Traces:
    """A run's traced windows, one after the other in the measured loop:
    first one of the device alone (``busy_s`` and ``window_s``: tracing the
    host's operations slows the host, which would inflate the idle share),
    then one of the host and the device (the kernel ranges, the device
    operations and the idle gaps by what the host was doing).  ``probes``
    count kernel work while the second is open."""

    def __init__(self, start: int, length: int, path: str, device, probes,
                 ranges_expected=()):
        self.probes = probes
        self.device_only = TraceWindow(start, length, path, device=device, host=False)
        self.with_host = TraceWindow(start, length, path, ranges_expected,
                                     on_open=probes.work.clear, device=device)

    def tick(self, iteration: int) -> None:
        if not self.device_only.done:
            self.device_only.tick(iteration)
        if self.device_only.done and not self.with_host.done:
            self.with_host.start = max(self.with_host.start, iteration)
            self.with_host.tick(iteration)
        self.probes.counting = self.with_host.is_open

    def finish(self, run) -> None:
        """The readings into ``run`` (``bench.Run``)."""
        device, host = self.device_only.finish(), self.with_host.finish()
        self.probes.counting = False
        run.traces_set_aside = len(self.device_only.set_aside) + len(self.with_host.set_aside)
        run.trace_overhead_s = self.device_only.overhead_s + self.with_host.overhead_s
        if device is None or host is None:
            return
        run.traced = {**host, "busy_s": device["busy_s"], "window_s": device["window_s"],
                      "host_traced_busy_s": host["busy_s"],
                      "host_traced_window_s": host["window_s"]}
        run.kernel_bounds = self.probes.kernel_bounds()
