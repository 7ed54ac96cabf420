"""``eval.k7_calls_per_batch``: K7's counter over the traced batches'
dispatch spans on a hand-made table, and None where nothing was traced or
the program keeps no such counter (the parent of the change)."""

import sys

import pytest

from portbench import bench

MS = 1_000_000


def _table(calls):
    from pctrans_torch.utils.tracing import Record as R

    spans = [R("eval.dispatch", None, 0, 0, 4 * MS, 4 * MS),
             R("eval.dispatch", None, 1, 5 * MS, 9 * MS, 4 * MS),
             R("eval.rerun", "eval.cluster", 0, 10 * MS, 14 * MS, 4 * MS),
             R("eval.cluster", None, 0, 9 * MS, 15 * MS, 2 * MS),
             R("eval.collect", None, 0, 16 * MS, 17 * MS, 1 * MS)]
    counts = [("host_syncs", ("eval.cluster",), 0, 2)]
    counts += [("mask_stats_kernel", path, key, 1) for path, key in calls]
    return {"spans": spans, "counts": counts}


READER = bench.load_module("metrics", "eval.k7_calls_per_batch")
# batch 0: its dispatch, its re-run and its merged masks; batch 1: its dispatch
CVPPP = [(("eval.dispatch",), 0), (("eval.cluster", "eval.rerun"), 0),
         (("eval.cluster",), 0), (("eval.dispatch",), 1)]


@pytest.mark.parametrize("calls,per_batch", [(CVPPP, 2.0), (CVPPP[:2], 1.0), ([], 0.0),
                                             (CVPPP + [(("train.step",), 0)], 2.0)])
def test_calls_over_dispatch_spans(calls, per_batch, monkeypatch):
    from pctrans_torch.utils import tracing

    monkeypatch.setattr(tracing, "table", lambda: _table(calls))
    assert READER.read(None) == pytest.approx(per_batch)


def test_none_where_nothing_was_traced(monkeypatch):
    from pctrans_torch.utils import tracing

    monkeypatch.setattr(tracing, "table", lambda: {"spans": [], "counts": []})
    assert READER.read(None) is None


def test_none_for_a_program_without_the_counter(monkeypatch):
    from pctrans_torch.utils import tracing

    monkeypatch.setattr(tracing, "table", lambda: _table(CVPPP))
    monkeypatch.setattr(tracing, "COUNTERS", ("host_syncs", "graph_replays"))
    assert READER.read(None) is None
    monkeypatch.delattr(tracing, "COUNTERS")
    assert READER.read(None) is None
    monkeypatch.setitem(sys.modules, "pctrans_torch.utils.tracing", None)
    assert READER.read(None) is None


def test_listed_for_the_eval_cells():
    listed = {m["name"]: m for m in bench.manifest()["per_layer"]}
    m = listed["eval.k7_calls_per_batch"]
    assert {"bbbc.eval", "cvppp.eval", "cvppp-swinl.eval"} <= set(m["workloads"])
    assert (m["layer"], m["moves"], m["source"]) == (
        "Device postprocess (inference/device_postprocess.py)", "eval_img_per_s",
        "program_counter")
