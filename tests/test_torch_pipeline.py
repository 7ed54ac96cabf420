"""The eval loops' software pipeline: ``pipeline_batches`` against the JAX
package's on the same stage callables (the order of every stage call and
the yielded order), and ``Evaluator._label_pipeline``'s labels against the
serial ``predict_labels`` on every batch, bit for bit, for both recipes,
with full-Q re-runs forced on some batches and a padded last batch; the
forwards are counted alike.  CPU: every host copy is synchronous."""

import numpy as np
import pytest
import torch

from pctrans_tpu.inference.device_postprocess import pipeline_batches as jax_pipeline
from pctrans_torch.engine.evaluator import Evaluator
from pctrans_torch.inference.device_postprocess import (HostCopy, copy_to_host_async,
                                                        pipeline_batches)
from test_torch_evaluator import HW, _batches, _model

torch.set_num_threads(1)


def _run(pipeline, n_batches, n_stages):
    calls = []

    def stage(i):
        def fn(batch, value):
            calls.append((i, batch))
            return (value or ()) + (i,)
        return fn

    out = list(pipeline(range(n_batches), *[stage(i) for i in range(n_stages)]))
    return calls, out


@pytest.mark.parametrize("n_stages", [1, 2, 3, 5])
@pytest.mark.parametrize("n_batches", [0, 1, 2, 4, 7])
def test_pipeline_batches_matches_jax(n_batches, n_stages):
    calls, out = _run(pipeline_batches, n_batches, n_stages)
    assert (calls, out) == _run(jax_pipeline, n_batches, n_stages)
    assert out == [(b, tuple(range(n_stages))) for b in range(n_batches)]


def test_stage_zero_runs_one_batch_ahead():
    """Five stages: batch n+1 is dispatched before batch n is clustered."""
    calls, _ = _run(pipeline_batches, 3, 5)
    assert calls.index((0, 1)) < calls.index((1, 0)) < calls.index((2, 0))


def test_host_copy_on_the_cpu_is_done_at_once():
    t = torch.arange(6.0).reshape(2, 3)
    c = copy_to_host_async(t)
    t.add_(1.0)                               # the copy does not alias its source
    assert isinstance(c, HostCopy) and c.event is None
    assert torch.equal(c.wait(), torch.arange(6.0).reshape(2, 3))


class _ForcedReruns(Evaluator):
    """Every second lossiness check says lossy: full-Q re-runs on some
    batches and not others, in the same order serially and pipelined."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.checks = 0

    def _lossy(self, masks, stats):
        self.checks += 1
        return masks.shape[1] < self.num_queries and self.checks % 2 == 0


def _padded(batches):
    """The last batch padded to full size as the eval loaders pad it."""
    *head, last = batches
    last = {k: np.concatenate([v[:1], v[:1]]) for k, v in last.items()}
    last["_num_valid"] = np.int32(1)
    return head + [last]


@pytest.mark.parametrize("dataset", ["cvppp", "bbbc"])
@pytest.mark.parametrize("top_k", [None, 4])
def test_pipelined_labels_equal_serial_labels(dataset, top_k):
    batches = _padded(list(_batches(4, seed=5)))
    serial_ev = _ForcedReruns(_model(), top_k=top_k, dataset=dataset)
    serial = [serial_ev.predict_labels(b["image"]) for b in batches]
    ev = _ForcedReruns(_model(), top_k=top_k, dataset=dataset)
    out = list(ev._label_pipeline(batches))
    assert [b is a for (b, _), a in zip(out, batches)] == [True] * len(batches)
    for (_, labels), ref in zip(out, serial):
        assert labels.dtype == ref.dtype and labels.shape == (2,) + HW
        np.testing.assert_array_equal(labels, ref)
    assert ev.forwards == serial_ev.forwards
    if top_k is not None:
        assert ev.forwards == len(batches) + len(batches) // 2      # re-runs ran
    assert sum(int(l.max()) for l in serial) > 0                    # labels not all empty


def test_eval_cvppp_scores_the_pipelined_labels():
    from pctrans_torch.inference import metrics_cvppp as mc

    batches = _padded(list(_batches(3, seed=6)))
    ev = Evaluator(_model(), top_k=4)
    sbd, dic = [], []
    for batch in batches:
        labels = Evaluator(_model(), top_k=4).predict_labels(batch["image"])
        for b in range(int(batch.get("_num_valid", 2))):
            seg, gt = labels[b].astype(np.uint16), batch["label"][b].astype(np.uint16)
            sbd.append(mc.SymmetricBestDice(seg, gt))
            dic.append(abs(mc.DiffFGLabels(seg, gt)))
    total_sbd = total_dic = 0.0           # in order: Python's sum() compensates
    for a, b in zip(sbd, dic):
        total_sbd += a
        total_dic += b
    assert ev.eval_cvppp(batches) == {"SBD": total_sbd / len(sbd),
                                      "absDiffFG": total_dic / len(dic)}
