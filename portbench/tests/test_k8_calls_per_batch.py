"""``eval.k8_calls_per_batch``: K8's counter over the traced batches'
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
             R("eval.finish", None, 0, 10 * MS, 14 * MS, 4 * MS),
             R("eval.collect", None, 0, 16 * MS, 17 * MS, 1 * MS)]
    counts = [("host_syncs", ("eval.collect",), 0, 1)]
    counts += [("label_pairs_kernel", path, key, 1) for path, key in calls]
    return {"spans": spans, "counts": counts}


READER = bench.load_module("metrics", "eval.k8_calls_per_batch")
# each batch's tables, in its finish stage
CALLS = [(("eval.finish",), 0), (("eval.finish",), 1)]


@pytest.mark.parametrize("calls,per_batch", [(CALLS, 1.0), (CALLS[:1], 0.5), ([], 0.0),
                                             (CALLS + [(("train.validate",), 0)], 1.0)])
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

    monkeypatch.setattr(tracing, "table", lambda: _table(CALLS))
    monkeypatch.setattr(tracing, "COUNTERS", ("host_syncs", "mask_stats_kernel"))
    assert READER.read(None) is None
    monkeypatch.delattr(tracing, "COUNTERS")
    assert READER.read(None) is None
    monkeypatch.setitem(sys.modules, "pctrans_torch.utils.tracing", None)
    assert READER.read(None) is None


def test_listed_for_the_eval_cells():
    listed = {m["name"]: m for m in bench.manifest()["per_layer"]}
    m = listed["eval.k8_calls_per_batch"]
    assert {"bbbc.eval", "cvppp.eval", "cvppp-swinl.eval"} <= set(m["workloads"])
    assert (m["layer"], m["moves"], m["source"]) == (
        "Scoring (inference/metrics_cvppp.py, metrics_bbbc.py)", "eval_img_per_s",
        "program_counter")
