"""What the per-layer metric readers share: each reader
(``portbench/metrics/<name>.py``) is one call of these on the run, and
returns None where the run holds nothing to read."""

from __future__ import annotations

from typing import Optional

from .bench import Run
from .timing import PEAK_BF16_FLOP_PER_S


def per(run: Run, span: str, counter: str) -> Optional[float]:
    """The host ms of ``span`` summed over the window, per ``counter``
    (iterations or batches)."""
    xs = run.spans.get(span)
    n = run.counters.get(counter)
    if not xs or not n:
        return None
    return sum(xs) / n


def idle_pct(run: Run) -> Optional[float]:
    """The traced window's share with no kernel, copy or set on the card."""
    t = run.traced
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(run: Run, kernel: str) -> Optional[float]:
    """The bound of the calls counted in the traced window over the device
    time of every kernel launched inside their ranges."""
    name = f"portbench.{kernel}"
    bound = run.kernel_bounds.get(name)
    r = (run.traced or {}).get("ranges", {}).get(name)
    if not bound or not r or r["device_s"] <= 0 or bound["calls"] != r["count"]:
        return None
    return 100.0 * bound["bound_s"] / r["device_s"]


def mfu_pct(run: Run, flops_per_unit: str, units: str) -> Optional[float]:
    """Model FLOPs of the window's work over its seconds, as a share of the
    H100's dense bf16 peak (989 TFLOP/s at 700 W)."""
    f, n = run.counters.get(flops_per_unit), run.counters.get(units)
    seconds = run.window_s - run.trace_overhead_s      # less opening and reading traces
    if not f or not n or seconds <= 0:
        return None
    return 100.0 * f * n / seconds / PEAK_BF16_FLOP_PER_S
