"""Finding a cell's files by name, and the result line.

A cell ``NAME`` of ``BENCHMARK.json`` is ``portbench/workloads/NAME.json``:
its configuration (``portbench/configs/<config>.json``), its traffic
(``portbench/traffic/<traffic>.json``), its entry
(``portbench/entries/<entry>.py``, whose ``run(ctx)`` loads, warms, measures
and checks) and the limits of its correctness check.  A per-layer metric
``M`` is read by ``portbench/metrics/M.py``'s ``read(run)``; a reader that
finds nothing returns None and the metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BUILD = REPO / "build" / "portbench"


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return read_json(REPO / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict                 # portbench/workloads/<name>.json
    config: dict                   # portbench/configs/<config>.json
    traffic: dict                  # portbench/traffic/<traffic>.json
    end_to_end: List[dict]         # BENCHMARK.json's metrics this cell reports
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def yamls(self) -> List[str]:
        return [str(REPO / p) for p in self.config["yaml"]]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = manifest() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    workload = read_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} in its workload file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    return Cell(name=name, workload=workload,
                config=read_json(HERE / "configs" / f"{entry['config']}.json"),
                traffic=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


@dataclasses.dataclass
class Check:
    """One number of the correctness check, with its limit (``value <=
    limit`` is correct)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What one run measured, for the result line and the metric readers."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda:0"
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    traced: Optional[dict] = None          # trace.analyse's reading
    kernel_bounds: Dict[str, dict] = dataclasses.field(default_factory=dict)
    traces_set_aside: int = 0
    trace_overhead_s: float = 0.0          # opening and reading traces, inside the window
    setup_phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    fault: Optional[Any] = None            # faults.Fault, planted by the tests only

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def device_info(run: Run) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and run.traced is not None:
        info["busy_s"] = run.traced["busy_s"]
        info["window_s"] = run.traced["window_s"]
    return info


def result_line(run: Run) -> dict:
    """The last line of standard output; the checks' key comes last."""
    metrics = {}
    if run.trace:
        for m in run.cell.per_layer:
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device_info(run)}
    if run.trace and run.traced is not None:
        line["breakdown"] = {"device_ops": run.traced["device_ops"],
                             "idle_gaps": run.traced["idle_gaps"]}
        line["traces_set_aside"] = run.traces_set_aside
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return line


class Phases:
    """Host seconds of the set-up's phases, for the run's log."""

    def __init__(self, run: Run):
        import time

        self.run, self.time = run, time
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = self.time.perf_counter()
        self.run.setup_phases[name] = now - self.t
        self.t = now


def print_checks(run: Run) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()


def cache_dirs() -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths (the kernel library builds into ``build/
    pctrans_torch_kernels/`` by itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = REPO / "build" / "cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
