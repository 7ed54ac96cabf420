"""The correctness check drives the rest of a run on the CPU (no look for
a card; the program's wrappers take their plain twins there, so the
program and the reference agree to rounding): a sound run is correct; a
run with the timed path broken underneath is not, for each fault the cell
can have; and the control, the reference computed in float8 e4m3 in the
program's place, is not correct at the cell's limits."""

import pytest

from portbench import control, faults
from portbench.bench import Check, Run
from tiny import tiny_cell, tiny_run

CELLS = ["cvppp.train", "bbbc.eval", "cvppp.eval"]
FAULTS = [("cvppp.train", "unchanged"), ("cvppp.train", "half"), ("cvppp.train", "altered"),
          ("bbbc.eval", "half"), ("bbbc.eval", "altered"),
          ("cvppp.eval", "half"), ("cvppp.eval", "altered")]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    # long enough for an eval window to label the sampled batches on a busy CPU
    run = tiny_run(cell, seconds=20.0)
    assert run.correct, [(c.name, c.value, c.limit) for c in run.checks]
    assert run.attempted > 0 and run.end_to_end["setup_s"] > 0
    for c in run.checks:
        assert c.value < 1e-6               # the twins are the reference's arithmetic


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_path_is_not_correct(cell, fault):
    run = tiny_run(cell, seconds=2.0, fault=faults.Fault(fault))
    assert not run.correct, [(c.name, c.value, c.limit) for c in run.checks]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = tiny_cell(cell)
    run = Run(cell=c, seed=11, seconds=0, trace=False, device="cpu")
    rows = control.readings(run, True, [])
    got = next(r for r in rows if r["reading"] == "control fp8")
    checks = [Check(k, got[k], float(v)) for k, v in c.workload["limits"].items()]
    assert not all(x.ok for x in checks), got
