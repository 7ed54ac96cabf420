"""The ``cvppp-swinl.eval`` cell (``entries/eval_swin.py``) at a tiny
Swin-L shape on the CPU (embed 32, heads 1/2/4/8 so every head is 32 wide,
depths 2/2/18/2, window 12, 112x104 scenes), where K6's wrapper takes its
twin: a sound run is correct and leaves ``entries/eval.py`` as it found
it; each eval fault and ``k6_doubled`` make it not correct; the control is
not correct at the cell's limits; the K6 range's work is K6's count."""

import dataclasses
import time

import pytest
import torch

from portbench import bench, control_swin, probes, trace
from portbench.bench import Check, Run
from portbench.entries import eval as eval_entry
from tiny import EVAL_OPTS, TINY_OPTS, tiny_config

SWIN_OPTS = ["MODEL.SWIN.EMBED_DIM", "32", "MODEL.SWIN.NUM_HEADS", "[1, 2, 4, 8]"]
CELL = "cvppp-swinl.eval"


def swin_cell() -> bench.Cell:
    cell = bench.load_cell(CELL)
    cell = dataclasses.replace(
        cell, config=tiny_config("cvppp-swinl", TINY_OPTS + EVAL_OPTS + SWIN_OPTS),
        traffic=dict(cell.traffic), workload=dict(cell.workload))
    cell.traffic.update(count=8, size=[112, 104])
    cell.workload.update(trace_start=1, trace_batches=2)
    return cell


def swin_run(seconds, fault=None) -> Run:
    run = Run(cell=swin_cell(), seed=2 ** 31 + 7, seconds=seconds, trace=False,
              device="cpu", fault=fault)
    bench.load_module("entries", "eval_swin").run(run, time.perf_counter())
    return run


def test_a_sound_run_is_correct_and_the_swap_is_undone():
    before = (eval_entry.build_evaluator, trace.KERNEL_RANGES, dict(probes.RANGE_UNITS))
    run = swin_run(20.0)
    assert run.correct, [(c.name, c.value, c.limit) for c in run.checks]
    for c in run.checks:
        assert c.value < 1e-6               # the twins are the reference's arithmetic
    assert (eval_entry.build_evaluator, trace.KERNEL_RANGES, dict(probes.RANGE_UNITS)) == before


@pytest.mark.parametrize("fault", ["half", "altered", "k6_doubled"])
def test_a_broken_path_is_not_correct(fault):
    from portbench import faults

    swin = bench.load_module("entries", "eval_swin")
    run = swin_run(2.0, swin.K6Doubled() if fault == "k6_doubled" else faults.Fault(fault))
    assert not run.correct, [(c.name, c.value, c.limit) for c in run.checks]


def test_the_control_is_not_correct():
    cell = swin_cell()
    rows = control_swin.readings(Run(cell=cell, seed=11, seconds=0, trace=False,
                                     device="cpu"), True, ["k6_doubled"])
    assert [r["reading"] for r in rows] == ["program", "control fp8", "fault k6_doubled"]
    for got in rows[1:]:
        checks = [Check(k, got[k], float(v)) for k, v in cell.workload["limits"].items()]
        assert not all(x.ok for x in checks), got


def test_k6_work_is_the_bytes_and_products_of_the_call():
    from portbench.counts.swin import window_attn_work

    qkv = torch.zeros(528, 144, 576, dtype=torch.bfloat16)
    table = torch.zeros(529, 6)
    out = torch.zeros(528, 144, 192, dtype=torch.bfloat16)
    n_bytes, flops = window_attn_work((qkv, table, 6, 12, 12, 6, (12, 11), 32 ** -0.5), out)
    assert n_bytes == 528 * 144 * (576 + 192) * 2 + 529 * 6 * 4
    assert flops == 4 * 144 * 144 * 32 * 528 * 6


@pytest.mark.parametrize("ws,grid,heads", [(12, (12, 11), 6), (12, (2, 2), 48), (7, (1, 1), 3)])
def test_k6_count_equals_chip_smokes(ws, grid, heads):
    """The K6 range's bytes and operations (``counts/swin.py``) and
    ``chip_smoke.py``'s, from which its kernels line bounds K6, on the same
    call."""
    import sys

    sys.path.insert(0, str(bench.REPO))
    import chip_smoke
    from portbench.counts.swin import window_attn_work

    qkv = torch.zeros(4 * grid[0] * grid[1], ws * ws, 3 * 32 * heads, dtype=torch.bfloat16)
    table = torch.zeros((2 * ws - 1) ** 2, heads)
    out = torch.zeros(qkv.shape[0], ws * ws, 32 * heads, dtype=torch.bfloat16)
    args = (qkv, table, heads, ws, ws, 0, grid, 32 ** -0.5)
    assert window_attn_work(args, out) == chip_smoke.window_attn_work(args, out)
