"""The p90, idle-share, roofline, MFU and rate arithmetic on a synthetic
trace and run, and the result line's shape."""

import json

import pytest
import torch

from portbench import bench, readers, timing, trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """Host thread 1: a K1 range at 0-10 us launching kernel 1 and a K4
    range at 20-30 us launching kernels 2 and 3, an op at 40-100 us; the
    device: kernels 1 (5-15), 2 (25-35) and 3 (35-45), a copy (90-100)."""
    return [
        ev("user_annotation", "portbench.k1", 0, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        ev("user_annotation", "portbench.k4", 20, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 22, 1, corr=3),
        ev("cpu_op", "aten::item", 40, 60),
        ev("cuda_runtime", "cudaMemcpyAsync", 80, 1, corr=4),
        ev("cuda_runtime", "cudaStreamSynchronize", 81, 1, corr=5),
        ev("kernel", "k1_kernel", 5, 10, tid=7, corr=1),
        ev("kernel", "k4_kernel", 25, 10, tid=7, corr=2),
        ev("kernel", "k4_tail", 35, 10, tid=7, corr=3),
        ev("gpu_memcpy", "Memcpy DtoH", 90, 10, tid=7, corr=4),
    ]


def test_analyse_busy_ranges_and_gaps():
    res = trace.analyse(synthetic_trace(), window_s=100e-6)
    assert res["busy_s"] == pytest.approx(40e-6)          # 5-15, 25-45, 90-100
    assert res["launches"] == 4 and res["launches_lost"] == 0
    assert res["ranges"]["portbench.k1"] == {"count": 1, "device_s": pytest.approx(10e-6),
                                             "empty": 0}
    assert res["ranges"]["portbench.k4"]["device_s"] == pytest.approx(20e-6)
    gaps = dict(res["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(45e-6)      # 45-90: the copy's thread
    assert gaps["host"] == pytest.approx(10e-6)            # 15-25: nothing open at 15
    assert trace.why_again(res, ("portbench.k1", "portbench.k4")) is None


def test_a_trace_that_lost_a_range_is_set_aside():
    events = [e for e in synthetic_trace() if e.get("args", {}).get("correlation") != 1
              or e["cat"] != "kernel"]
    res = trace.analyse(events, window_s=100e-6)
    assert res["launches_lost"] == 1
    assert trace.why_again(res, ("portbench.k1",)) is not None


def test_quantile_is_the_linear_p90():
    xs = list(range(1, 101))
    assert timing.quantile(xs, 0.9) == pytest.approx(90.1)
    assert timing.quantile([5.0], 0.9) == 5.0 and timing.quantile([], 0.9) is None


def run_with(**kw):
    cell = bench.load_cell("cvppp.eval")
    run = bench.Run(cell=cell, seed=1, seconds=30, trace=True, device="cpu")
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_readers_idle_roofline_mfu_and_rates():
    run = run_with(traced={"busy_s": 0.25, "window_s": 1.0,
                           "ranges": {"portbench.k1": {"count": 4, "device_s": 2e-3, "empty": 0}}},
                   kernel_bounds={"portbench.k1": {"bound_s": 5e-4, "calls": 4}},
                   counters={"batches": 10, "forwards": 20, "eval_flops_per_forward": 4e11},
                   spans={"postprocess": [1.0] * 20, "scoring": [3.0] * 10},
                   window_s=2.0, trace_overhead_s=1.0)
    assert readers.idle_pct(run) == pytest.approx(75.0)
    assert readers.roofline_pct(run, "k1") == pytest.approx(25.0)
    assert readers.roofline_pct(run, "k3") is None
    assert readers.mfu_pct(run, "eval_flops_per_forward", "forwards") == pytest.approx(
        100 * 4e11 * 20 / 1.0 / timing.PEAK_BF16_FLOP_PER_S)
    assert readers.per(run, "postprocess", "batches") == pytest.approx(2.0)
    assert bench.load_module("metrics", "eval.forwards_per_batch").read(run) == 2.0
    # a range whose calls were not all counted reads nothing, never 0
    run.kernel_bounds["portbench.k1"]["calls"] = 3
    assert readers.roofline_pct(run, "k1") is None


def test_bound_is_the_larger_of_bytes_and_operations():
    ms, by = timing.bound_ms(3.35e9, 1e9, timing.PEAK_F32_FLOP_PER_S)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = timing.bound_ms(0, 67e9, timing.PEAK_F32_FLOP_PER_S)
    assert by == "operations" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contracts_shape(monkeypatch, traced):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")
    run = run_with(trace=traced, attempted=40, failed=0, memory_peak_bytes=123,
                   end_to_end={"eval_img_per_s": 20.5, "eval_latency_p90_ms": 800.0,
                               "setup_s": 12.0},
                   counters={"batches": 10, "forwards": 20},
                   traced={"busy_s": 0.3, "window_s": 1.0, "ranges": {},
                           "device_ops": [["k", 0.1]], "idle_gaps": [["host", 0.2]]},
                   checks=[bench.Check("mask_area", 0.01, 0.05), bench.Check("labels", 0.1, 0.5)])
    line = json.loads(json.dumps(bench.result_line(run)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if traced:
        assert line["metrics"] == {
            "eval.forwards_per_batch": {"value": 2.0, "unit": "forwards/batch"},
            "eval.device_idle_pct": {"value": pytest.approx(70.0), "unit": "%"}}
        assert line["device"]["busy_s"] == 0.3 and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"eval_img_per_s", "eval_latency_p90_ms", "setup_s"}
    run.checks.append(bench.Check("x", float("nan"), 1.0))
    assert bench.result_line(run)["correct"] is False
