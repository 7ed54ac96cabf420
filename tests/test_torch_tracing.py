"""The port's spans and counters (``pctrans_torch/utils/tracing.py``) on
the CPU: off, a train step and an eval protocol open no ``pctrans.*``
range and record nothing; on, every phase span once per step and every
label pipeline stage once per batch under the batch's key, nested as the
code nests them; self time is a span less its children; counters go to
the innermost open span, the sync warning counted and not shown; a
profiler window turns the spans on, and the monitor's window logs the
phases and carries the ranges in its trace."""

import json
import time
import warnings
from collections import Counter

import pytest
import torch

from pctrans_torch import config
from pctrans_torch.engine.evaluator import Evaluator
from pctrans_torch.engine.trainer import Trainer
from pctrans_torch.utils import tracing
from pctrans_torch.utils.monitor import PHASES, phase_ms
from test_torch_evaluator import _batches, _model
from test_torch_trainer import tiny_opts

torch.set_num_threads(1)

STEP_PHASES = ["step.input", "step.forward", "step.criterion", "step.backward",
               "step.allreduce", "step.optimizer"]
STAGES = ["eval.dispatch", "eval.cluster", "eval.finish", "eval.collect", "eval.score"]


@pytest.fixture(autouse=True)
def fresh_table():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _train(tmp_path, iters, extra=()):
    opts = tiny_opts(tmp_path) + ["SOLVER.ITERATION_TOTAL", str(iters),
                                  "SOLVER.ITERATION_VAL", "0", "SOLVER.START_SAVE", "100"]
    trainer = Trainer(config.load_cfg(opts=opts + list(extra)), mode="train", device="cpu")
    trainer.train()
    return trainer


def _eval(protocol="eval_cvppp", n=3):
    ev = Evaluator(_model(mask_logit=20.0), top_k=4,
                   dataset="bbbc" if protocol == "test_bbbc" else "cvppp")
    getattr(ev, protocol)(_batches(n))
    return ev


@pytest.mark.parametrize("what", ["train", "eval"])
def test_off_opens_no_range_and_records_nothing(tmp_path, monkeypatch, what):
    opened = []
    real = torch.autograd.profiler.record_function

    class Recorder(real):
        def __init__(self, name, *args, **kwargs):
            opened.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Recorder)
    _train(tmp_path, 1) if what == "train" else _eval()
    assert not [n for n in opened if n.startswith("pctrans.")]
    assert tracing.table() == {"spans": [], "counts": []}


def test_train_phases_once_per_step_nested(tmp_path):
    tracing.enable()
    _train(tmp_path, 2)
    spans = tracing.table()["spans"]
    by_key = {k: Counter(r.name for r in spans if r.key == k) for k in (0, 1)}
    for k in (0, 1):
        for name in ["train.iteration", "train.loader", "train.step", "train.monitor",
                     "criterion.match", "model.backbone", "model.pixel_decoder",
                     "model.predictor"] + STEP_PHASES:
            assert by_key[k][name] == 1, (k, name)
    parents = {r.name: r.parent for r in spans}
    assert parents["train.iteration"] is None
    assert parents["train.step"] == parents["train.loader"] == "train.iteration"
    assert all(parents[p] == "train.step" for p in STEP_PHASES)
    assert parents["criterion.match"] == "step.criterion"
    assert parents["model.predictor"] == "step.forward"
    assert parents["wait.lap_costs"] == "criterion.match"
    assert parents["wait.monitor"] == "train.monitor"
    # the phases tile the step: its self time is a small rest
    for k in (0, 1):
        step = next(r for r in spans if r.name == "train.step" and r.key == k)
        phases = sum(r.t1_ns - r.t0_ns for r in spans if r.key == k and r.name in STEP_PHASES)
        assert step.self_ns == step.t1_ns - step.t0_ns - phases


@pytest.mark.parametrize("protocol", ["eval_cvppp", "test_bbbc"])
def test_eval_stages_once_per_batch_under_its_key(protocol):
    tracing.enable()
    ev = _eval(protocol, n=3)
    assert ev.forwards == 6                     # every batch lossy: TOP_K, then full Q
    spans = tracing.table()["spans"]
    for name in STAGES + ["eval.rerun"]:
        assert sorted(r.key for r in spans if r.name == name) == [0, 1, 2], name
    parents = {(r.name, r.parent) for r in spans}
    assert ("eval.rerun", "eval.cluster") in parents
    assert ("model.backbone", "eval.dispatch") in parents
    assert ("model.backbone", "eval.rerun") in parents
    assert ("wait.labels", "eval.collect") in parents
    assert all(r.parent is None for r in spans if r.name in STAGES)
    # a stage's children carry its batch's key
    for r in spans:
        if r.parent in STAGES:
            outer = [o for o in spans if o.name == r.parent and o.t0_ns <= r.t0_ns
                     and r.t1_ns <= o.t1_ns]
            assert [o.key for o in outer] == [r.key]


def test_self_time_is_the_span_less_its_children():
    tracing.enable()
    with tracing.span("outer", key=7):
        time.sleep(0.01)
        with tracing.span("a"):
            time.sleep(0.02)
        with tracing.span("b"):
            with tracing.span("c"):
                time.sleep(0.01)
    spans = {r.name: r for r in tracing.table()["spans"]}
    assert [r.name for r in tracing.table()["spans"]] == ["a", "c", "b", "outer"]
    assert {r.key for r in spans.values()} == {7}
    assert spans["a"].parent == spans["b"].parent == "outer" and spans["c"].parent == "b"

    def d(r):
        return r.t1_ns - r.t0_ns
    assert spans["outer"].self_ns == d(spans["outer"]) - d(spans["a"]) - d(spans["b"])
    assert spans["b"].self_ns == d(spans["b"]) - d(spans["c"])
    assert spans["a"].self_ns == d(spans["a"]) and spans["outer"].self_ns >= 10_000_000


def test_counters_go_to_the_innermost_span_and_syncs_are_counted_not_shown():
    tracing.count("host_syncs")                 # off, outside any span: dropped
    tracing.enable()
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with tracing.span("outer", key=3):
            tracing.count("host_syncs", 2)
            with tracing.span("inner"):
                for _ in range(3):
                    warnings.warn(tracing.SYNC_WARNING + " (Triggered internally)")
            warnings.warn("another warning")
        warnings.warn(tracing.SYNC_WARNING)      # outside spans: shown
    assert sorted(tracing.table()["counts"]) == [
        ("host_syncs", ("outer",), 3, 2), ("host_syncs", ("outer", "inner"), 3, 3)]
    assert [str(w.message) for w in shown] == ["another warning", tracing.SYNC_WARNING]


def test_a_profiler_window_turns_the_spans_on(tmp_path):
    with tracing.span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("inside", key=1):
            torch.ones(3).sum()
    with tracing.span("after"):
        pass
    assert [r.name for r in tracing.table()["spans"]] == ["inside"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e.get("name") for e in json.loads(path.read_text())["traceEvents"]]
    assert "pctrans.inside" in names and "pctrans.before" not in names


def test_windows_that_turn_over_inside_an_unranged_span(tmp_path):
    # as a benchmark's step wrapper closes one traced window and opens the
    # next inside an iteration: the iteration keeps its record, no range
    cpu = [torch.profiler.ProfilerActivity.CPU]
    first = torch.profiler.profile(activities=cpu)
    first.start()
    with tracing.span("iteration", key=5, ranged=False):
        with tracing.span("before"):
            torch.ones(3).sum()
        first.stop()
        second = torch.profiler.profile(activities=cpu)
        second.start()
        with tracing.span("after"):
            torch.ones(3).sum()
    second.stop()
    got = {r.name: (r.parent, r.key) for r in tracing.table()["spans"]}
    assert got == {"before": ("iteration", 5), "after": ("iteration", 5),
                   "iteration": (None, 5)}
    path = tmp_path / "trace.json"
    second.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "pctrans.after" in names and "pctrans.iteration" not in names


def test_monitor_window_logs_phases_and_traces_the_ranges(tmp_path, capsys):
    trainer = _train(tmp_path, 4, ["MONITOR.PROFILE_ITERS", "[1, 4]"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[Iteration")]
    assert len(lines) == 4 and "ms/iter" not in lines[0] + lines[1]
    for line in lines[2:]:                      # iterations 1 and 2 closed by then
        logged = dict(kv.rsplit(" ", 1) for kv in line.split("ms/iter: ")[1].split(", "))
        assert set(logged) == set(PHASES) | {"outside"}
        assert float(logged["forward"]) > 0 and float(logged["backward"]) > 0
    events = json.loads(open(trainer.monitor.trace_path).read())["traceEvents"]
    ranges = Counter(e["name"] for e in events if str(e.get("name", "")).startswith("pctrans."))
    assert ranges["pctrans.train.step"] == ranges["pctrans.train.loader"] == 3
    assert all(ranges["pctrans." + p] == 3 for p in STEP_PHASES)
    assert "pctrans.train.iteration" not in ranges      # a record only
    assert sum(r.name == "train.iteration" for r in tracing.table()["spans"]) == 3
    assert ranges["pctrans.model.pixel_decoder"] == 3


def test_phase_ms_averages_whole_iterations():
    R = tracing.Record
    ms = 1_000_000
    spans = [R("step.forward", "train.step", 0, 0, 5 * ms, 5 * ms),
             R("train.step", "train.iteration", 0, 0, 8 * ms, 3 * ms),
             R("train.iteration", None, 0, 0, 10 * ms, 2 * ms),
             R("step.forward", "train.step", 1, 0, 7 * ms, 7 * ms),
             R("train.step", "train.iteration", 1, 0, 9 * ms, 2 * ms),
             R("train.iteration", None, 1, 0, 12 * ms, 3 * ms),
             R("step.forward", "train.step", 2, 0, 100 * ms, 100 * ms)]   # no iteration
    got = phase_ms(spans)
    assert got["forward"] == 6.0 and got["outside"] == 2.5 and got["backward"] == 0.0
    assert phase_ms(spans[-1:]) == {}
