"""``eval.graph_replay_share``: replays over the forwards of the traced
batches on a hand-made table, and None where nothing was traced or the
program keeps no graph counter (the parent of the change)."""

import sys

import pytest

from portbench import bench

MS = 1_000_000


def _table(replays):
    from pctrans_torch.utils.tracing import Record as R

    spans = [R("eval.dispatch", None, 0, 0, 4 * MS, 4 * MS),
             R("eval.dispatch", None, 1, 5 * MS, 9 * MS, 4 * MS),
             R("eval.rerun", "eval.cluster", 0, 10 * MS, 14 * MS, 4 * MS),
             R("eval.cluster", None, 0, 9 * MS, 15 * MS, 2 * MS),
             R("eval.collect", None, 0, 16 * MS, 17 * MS, 1 * MS)]
    counts = [("host_syncs", ("eval.cluster",), 0, 2)]
    counts += [("graph_replays", path, key, 1) for path, key in replays]
    return {"spans": spans, "counts": counts}


READER = bench.load_module("metrics", "eval.graph_replay_share")
ALL = [(("eval.dispatch",), 0), (("eval.dispatch",), 1), (("eval.cluster", "eval.rerun"), 0)]


@pytest.mark.parametrize("replays,share", [(ALL, 1.0), (ALL[:1], 1 / 3), ([], 0.0)])
def test_share_is_replays_over_forwards(replays, share, monkeypatch):
    from pctrans_torch.utils import tracing

    monkeypatch.setattr(tracing, "table", lambda: _table(replays))
    assert READER.read(None) == pytest.approx(share)


def test_none_where_nothing_was_traced(monkeypatch):
    from pctrans_torch.utils import tracing

    monkeypatch.setattr(tracing, "table", lambda: {"spans": [], "counts": []})
    assert READER.read(None) is None


def test_none_for_a_program_without_graph_counters(monkeypatch):
    from pctrans_torch.utils import tracing

    monkeypatch.setattr(tracing, "table", lambda: _table(ALL))
    monkeypatch.delattr(tracing, "COUNTERS")
    assert READER.read(None) is None
    monkeypatch.setitem(sys.modules, "pctrans_torch.utils.tracing", None)
    assert READER.read(None) is None


def test_listed_for_the_eval_cells():
    listed = {m["name"]: m for m in bench.manifest()["per_layer"]}
    m = listed["eval.graph_replay_share"]
    assert m["workloads"] == ["bbbc.eval", "cvppp.eval"]
    assert (m["layer"], m["moves"], m["source"]) == (
        "Eval step (engine/eval_step.py)", "eval_img_per_s", "program_counter")
