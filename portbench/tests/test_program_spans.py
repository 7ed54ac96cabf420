"""The readers of the program's spans and counters, and the analysis of
the program's ranges in a traced window: each reader gives the number a
synthetic table implies and None where there is nothing to read (no table,
no tracing module); ``trace.analyse`` gives what it gave before the
program had ranges; ``program_trace.analyse`` puts each launch's device
time in the ranges open at the launch, the backward's from autograd's
thread included, and names every idle gap; a tiny traced run of each cell
prints every new metric of that cell."""

import sys

import pytest
import torch

from portbench import bench, program_trace, trace
from tiny import tiny_run

MS = 1_000_000


def _table():
    from pctrans_torch.utils.tracing import Record as R

    spans = [
        # iteration 4: whole
        R("train.loader", "train.iteration", 4, 0, 1 * MS, 1 * MS),
        R("step.input", "train.step", 4, 1 * MS, 3 * MS, 2 * MS),
        R("step.forward", "train.step", 4, 3 * MS, 13 * MS, 10 * MS),
        R("wait.lap_costs", "criterion.match", 4, 14 * MS, 15 * MS, 1 * MS),
        R("step.criterion", "train.step", 4, 13 * MS, 16 * MS, 2 * MS),
        R("step.backward", "train.step", 4, 16 * MS, 30 * MS, 14 * MS),
        R("step.allreduce", "train.step", 4, 30 * MS, 31 * MS, 1 * MS),
        R("step.optimizer", "train.step", 4, 31 * MS, 35 * MS, 4 * MS),
        R("train.step", "train.iteration", 4, 1 * MS, 36 * MS, 1 * MS),
        R("wait.monitor", "train.monitor", 4, 36 * MS, 38 * MS, 2 * MS),
        R("train.monitor", "train.iteration", 4, 36 * MS, 38 * MS, 0),
        R("train.iteration", None, 4, 0, 40 * MS, 2 * MS),
        # iteration 5: whole
        R("step.forward", "train.step", 5, 41 * MS, 49 * MS, 8 * MS),
        R("train.step", "train.iteration", 5, 41 * MS, 60 * MS, 11 * MS),
        R("train.iteration", None, 5, 40 * MS, 62 * MS, 3 * MS),
        # a step whose iteration began before the window opened: left out
        R("step.forward", "train.step", None, 0, 99 * MS, 99 * MS),
        # eval batches 0 and 1 whole, batch 2 dispatched only
        R("eval.dispatch", None, 0, 0, 4 * MS, 4 * MS),
        R("eval.dispatch", None, 1, 5 * MS, 11 * MS, 6 * MS),
        R("wait.stats", "eval.cluster", 0, 12 * MS, 13 * MS, 1 * MS),
        R("eval.cluster", None, 0, 11 * MS, 14 * MS, 2 * MS),
        R("eval.dispatch", None, 2, 15 * MS, 20 * MS, 5 * MS),
        R("eval.cluster", None, 1, 20 * MS, 25 * MS, 5 * MS),
        R("eval.finish", None, 0, 25 * MS, 26 * MS, 1 * MS),
        R("wait.labels", "eval.collect", 0, 30 * MS, 33 * MS, 3 * MS),
        R("eval.collect", None, 0, 30 * MS, 34 * MS, 1 * MS),
        R("eval.finish", None, 1, 35 * MS, 36 * MS, 1 * MS),
        R("eval.collect", None, 1, 40 * MS, 42 * MS, 2 * MS),
    ]
    counts = [("host_syncs", ("train.iteration", "train.step", "step.criterion"), 4, 3),
              ("host_syncs", ("train.iteration", "train.step", "step.backward"), 5, 5),
              ("host_syncs", ("train.iteration", "train.monitor"), 4, 7),
              ("host_syncs", ("train.iteration", "train.step"), None, 50),
              ("host_syncs", ("eval.cluster",), 0, 2), ("host_syncs", ("eval.collect",), 0, 4)]
    return {"spans": spans, "counts": counts}


EXPECTED = {
    "train.input_ms": 1.0, "train.forward_ms": 9.0, "train.criterion_ms": 1.5,
    "train.backward_ms": 7.0, "train.optimizer_ms": 2.5,
    # the Trainer's spans outside the step; the iterations' self time left out
    "train.outside_step_ms": (1 + 2) / 2,
    "train.device_wait_ms": (1 + 2) / 2 + 0, "train.host_syncs_per_step": (3 + 5) / 2,
    "eval.dispatch_ms": 5.0, "eval.cluster_ms": 4.0,
    # other batches' stages between a batch's dispatch start and collect end
    "eval.pipeline_wait_ms": ((6 + 5 + 5) + (3 + 5 + 1 + 4)) / 2,
    # every wait.* span of the table over the three batches dispatched
    "eval.device_wait_ms": (1 + 2 + 1 + 3) / 3, "eval.host_syncs_per_batch": 6 / 3,
}
NEW = list(EXPECTED)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_the_tables_number(name, monkeypatch):
    from pctrans_torch.utils import tracing

    monkeypatch.setattr(tracing, "table", _table)
    assert bench.load_module("metrics", name).read(None) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_without_spans_gives_none(name, monkeypatch):
    from pctrans_torch.utils import tracing

    monkeypatch.setattr(tracing, "table", lambda: {"spans": [], "counts": []})
    assert bench.load_module("metrics", name).read(None) is None
    # a program without the tracing module (the parent of the change)
    monkeypatch.setitem(sys.modules, "pctrans_torch.utils.tracing", None)
    assert bench.load_module("metrics", name).read(None) is None


def test_new_metrics_are_read_by_these_readers():
    listed = {m["name"]: m for m in bench.manifest()["per_layer"]}
    for name in NEW:
        cells = ["cvppp.train"] if name.startswith("train.") else ["bbbc.eval", "cvppp.eval"]
        assert listed[name]["workloads"] == cells
        assert listed[name]["source"] in ("program_span", "program_counter")


def chrome_trace():
    """A traced window: the loop's thread (1) opens the program's ranges and
    the harness's; autograd's thread (2) launches the backward's kernel."""
    ev = []

    def x(name, cat, ts, dur, tid, **args):
        ev.append({"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
                   "pid": 1, "args": args})
    for name, ts, end in [("pctrans.train.iteration", 0, 100), ("pctrans.train.step", 10, 90),
                          ("pctrans.step.forward", 10, 40), ("pctrans.model.backbone", 12, 30),
                          ("pctrans.step.backward", 50, 80), ("portbench.train_step", 5, 95),
                          ("portbench.k1", 20, 25)]:
        x(name, "user_annotation", ts, end - ts, 1)
    x("aten::empty", "cpu_op", 0, 1, 1)
    x("aten::mm", "cpu_op", 14, 2, 1)
    x("aten::copy_", "cpu_op", 60, 2, 2)
    x("aten::empty", "cpu_op", 99, 1, 1)
    # a range open when the window opened keeps its start, before the window
    x("pctrans.train.monitor", "user_annotation", -50, 45, 1)
    x("cudaLaunchKernel", "cuda_runtime", 14, 1, 1, correlation=1)
    x("cudaLaunchKernel", "cuda_runtime", 22, 1, 1, correlation=2)
    x("cudaLaunchKernel", "cuda_runtime", 55, 1, 2, correlation=3)
    x("cudaMemcpyAsync", "cuda_runtime", 85, 1, 1, correlation=4)
    x("cudaStreamSynchronize", "cuda_runtime", 86, 2, 1, correlation=5)
    x("cudaLaunchKernel", "cuda_runtime", 95, 1, 1, correlation=6)     # its event lost
    x("sm80_xmma_gemm_f32f32_tilesize32x32x8", "kernel", 15, 5, 7, correlation=1)
    x("k1_kernel", "kernel", 23, 5, 7, correlation=2)
    x("bwd_kernel", "kernel", 56, 14, 7, correlation=3)
    x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 87, 1, 8, correlation=4)
    return ev


# trace.analyse on chrome_trace() before the program opened ranges of its own
# (the harness keeps a kernel range's hits only: the other ranges keep theirs)
ANALYSE_BEFORE = (
    "{'busy_s': 2.4999999999999998e-05, 'window_s': 0.0001, 'device_events': 4, "
    "'launches': 5, 'launches_lost': 1, 'ranges': {'portbench.train_step': {'count': 1, "
    "'device_s': 0.0, 'empty': 0, '_hit': set()}, 'portbench.k1': {'count': 1, "
    "'device_s': 4.9999999999999996e-06, 'empty': 0}}, 'device_ops': [['bwd_kernel', "
    "1.4e-05], ['sm80_xmma_gemm_f32f32_tilesize32x32x8', 4.9999999999999996e-06], "
    "['k1_kernel', 4.9999999999999996e-06], ['Memcpy DtoH (Device -> Pinned)', 1e-06]], "
    "'idle_gaps': [['host', 2.8e-05], ['portbench.train_step', 1.7e-05], "
    "['portbench.k1', 3e-06]]}")


def test_trace_analyse_keeps_its_keys():
    assert repr(trace.analyse(chrome_trace(), 1e-4)) == ANALYSE_BEFORE


def test_program_ranges_hold_their_launches_the_backward_included():
    got = program_trace.analyse(chrome_trace())
    r = got["program_ranges"]
    assert {k: (v["count"], v["launches"], v["syncs"]) for k, v in r.items()} == {
        "train.monitor": (1, 0, 0), "train.iteration": (1, 5, 1), "train.step": (1, 4, 1), "step.forward": (1, 2, 0),
        "model.backbone": (1, 2, 0), "step.backward": (1, 1, 0)}
    us = {k: round(v["device_s"] * 1e6, 6) for k, v in r.items()}
    assert us == {"train.monitor": 0, "train.iteration": 25, "train.step": 25, "step.forward": 10,
                  "model.backbone": 10, "step.backward": 14}
    assert r["model.backbone"]["ops"][0] == ["sm80_xmma_gemm_f32f32_tilesize32x32x8",
                                             pytest.approx(5e-6)]
    assert r["step.backward"]["ops"] == [["bwd_kernel", pytest.approx(14e-6)]]


def test_program_gaps_name_every_idle_gap():
    got = program_trace.analyse(chrome_trace())
    gaps = {k: round(v * 1e6, 6) for k, v in got["program_gaps"]}
    assert gaps == {"model.backbone": 3 + 28, "step.backward": 17, "train.iteration": 15,
                    "train.step": 12}
    assert sum(gaps.values()) * 1e-6 + got["busy_s"] == pytest.approx(got["events_span_s"])


@pytest.mark.parametrize("cell", ["cvppp.train", "cvppp.eval"])
def test_a_traced_run_reads_every_new_metric(cell):
    from pctrans_torch.utils import tracing

    tracing.reset()
    threads = torch.get_num_threads()
    # the window is sized from the step's rate, which oversubscribed cores cut to a step
    torch.set_num_threads(1)
    try:
        run = tiny_run(cell, seconds=12.0, trace=True)
        for m in run.cell.per_layer:
            if m["name"] in NEW:
                value = bench.load_module("metrics", m["name"]).read(run)
                assert value is not None and value >= 0, m["name"]
        assert tracing.table()["spans"]
    finally:
        torch.set_num_threads(threads)
        tracing.reset()
