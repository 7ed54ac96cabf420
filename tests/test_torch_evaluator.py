"""The PyTorch port's eval step and evaluator on the CPU (twins): the TOP_K
lossiness check and full-Q re-run (``engine/trainer.py:438-452``) for both
recipes, the step's packed statistics, the label chain through the device
postprocess, and the bf16 autocast forward."""

import dataclasses

import numpy as np
import pytest
import torch

from pctrans_torch.config import ModelConfig
from pctrans_torch.data.synthetic import make_blob_image
from pctrans_torch.engine.eval_step import make_eval_step
from pctrans_torch.engine.evaluator import Evaluator
from pctrans_torch.inference import device_postprocess as dp
from pctrans_torch.inference.postprocess import (instance_inference_bbbc,
                                                 instance_inference_cvppp)
from pctrans_torch.models import PCTransModel

torch.set_num_threads(1)

TINY = ModelConfig(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10,
                   nheads=4, dim_feedforward=64, enc_layers=1, dec_layers=3,
                   backbone_depth=14, head_norm="GN")
HW = (64, 60)


def _model(config=TINY, mask_logit=None):
    """Seeded model; with ``mask_logit`` every query renders that constant
    logit everywhere (the controller emits w3 = 0 and b3 = mask_logit)."""
    model = PCTransModel(config, generator=torch.Generator().manual_seed(0)).eval()
    if mask_logit is not None:
        pred = model.predictor
        last = pred.controller.layers[-1]
        w3_start = sum(pred.split_sizes[:2])
        with torch.no_grad():
            for rows in (slice(w3_start, w3_start + pred.ch), slice(-1, None)):
                last.weight[rows] = 0.0
                last.bias[rows] = 0.0
            last.bias[-1] = mask_logit
    return model


def _batches(n, seed=0, batch=2):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        items = [make_blob_image(rng, HW, n_instances=(2, 4)) for _ in range(batch)]
        yield {"image": np.stack([i for i, _ in items]),
               "label": np.stack([l for _, l in items])}


def test_lossy_top_k_reruns_with_all_queries():
    ev = Evaluator(_model(mask_logit=20.0), top_k=4)
    masks = ev.predict_masks(next(_batches(1))["image"])
    assert ev.forwards == 2                     # top-k run, then full Q
    assert masks.shape == (2, TINY.num_queries) + HW
    assert (masks == 1).all()
    # ten identical full-image masks cluster into one instance
    labels = ev.predict_labels(next(_batches(1))["image"])
    assert labels.shape == (2,) + HW and (labels == 1).all()


def test_exact_top_k_keeps_k_masks():
    ev = Evaluator(_model(mask_logit=-20.0), top_k=4)
    masks = ev.predict_masks(next(_batches(1))["image"])
    assert ev.forwards == 1
    assert masks.shape == (2, 4) + HW and not masks.any()


def test_eval_cvppp_averages_the_metrics_over_images():
    from pctrans_torch.inference import metrics_cvppp as mc

    ev = Evaluator(_model(mask_logit=20.0), top_k=4)
    res = ev.eval_cvppp(_batches(2))
    sbd, dic = [], []
    for batch in _batches(2):
        for seg, gt in zip(ev.predict_labels(batch["image"]), batch["label"]):
            seg, gt = seg.astype(np.uint16), gt.astype(np.uint16)
            sbd.append(mc.SymmetricBestDice(seg, gt))
            dic.append(abs(mc.DiffFGLabels(seg, gt)))
    assert res == pytest.approx({"SBD": np.mean(sbd), "absDiffFG": np.mean(dic)})
    assert res["absDiffFG"] > 0          # one image-wide blob vs 2-4 leaves


def test_bf16_forward_runs_under_autocast():
    """The recipe's mixed precision on the CPU: bf16 mask logits, f32
    side outputs, close to the f32 forward before the decoder."""
    x = torch.from_numpy(next(_batches(1))["image"])
    with torch.no_grad():
        out16 = _model(dataclasses.replace(TINY, dtype="bfloat16"))(x)
        out32 = _model()(x)
    assert out16["pred_masks"].dtype == torch.bfloat16
    for k in ("query_emb", "sem_mask", "mask_features"):
        assert out16[k].dtype == torch.float32
    assert torch.isfinite(out16["pred_masks"].float()).all()
    a, b = out16["mask_features"], out32["mask_features"]
    assert float((a - b).norm() / b.norm()) < 5e-2   # bf16 rounding, 6 convs deep


@pytest.mark.parametrize("mask_logit,forwards,k", [(-2.0, 2, 10), (-3.5, 1, 4)])
def test_bbbc_reruns_a_lossy_top_k_batch_with_all_queries(mask_logit, forwards, k):
    """At BBBC's 0.05 threshold (logit -2.94) a constant logit of -2 clears
    it, so the top 4 are lossy and the batch runs again with all ten
    queries; -3.5 does not."""
    ev = Evaluator(_model(mask_logit=mask_logit), top_k=4, dataset="bbbc")
    assert ev.threshold == 0.05
    masks = ev.predict_masks(next(_batches(1))["image"])
    assert ev.forwards == forwards and masks.shape == (2, k) + HW
    assert bool(masks.all()) == (mask_logit > -2.94)
    labels = ev.predict_labels(next(_batches(1))["image"])
    assert labels.dtype == np.int16 and (labels == int(mask_logit > -2.94)).all()


@pytest.mark.parametrize("dataset", ["cvppp", "bbbc"])
def test_labels_are_the_oracles_on_the_steps_masks(dataset):
    """A seeded model: the device postprocess gives the numpy oracle's label
    maps on the eval step's own masks."""
    oracle = {"cvppp": instance_inference_cvppp, "bbbc": instance_inference_bbbc}[dataset]
    ev = Evaluator(_model(), top_k=4, dataset=dataset)
    masks, stats = ev.masks_and_stats(next(_batches(1, seed=3))["image"])
    labels = ev.label_masks(masks, stats)
    ref = np.stack([oracle(m.astype(np.float32), ev.threshold) for m in masks.numpy()])
    np.testing.assert_array_equal(labels, ref)


def test_predict_labels_fetches_statistics_and_labels_not_masks(monkeypatch):
    """Every host fetch goes through ``Tensor.cpu``: one predict_labels call
    fetches the packed statistics of each forward, CVPPP's merged
    statistics and the label map, never the [B, K, H, W] masks."""
    ev = Evaluator(_model(mask_logit=20.0), top_k=4)
    fetched = []
    cpu = torch.Tensor.cpu

    def record(t, *a, **k):
        fetched.append(tuple(t.shape))
        return cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", record)
    labels = ev.predict_labels(next(_batches(1))["image"])
    Q = TINY.num_queries
    assert fetched == [(2, 4, 6), (2, Q, Q + 2), (2, Q, Q + 1), (2,) + HW]
    assert labels.shape == (2,) + HW


def test_eval_step_with_stats_packs_the_masks_statistics():
    """``with_stats``: the same masks as the plain step, and statistics
    equal to those recomputed from them (peak logits in the last column)."""
    model = _model()
    x = torch.from_numpy(next(_batches(1, seed=5))["image"])
    m0, peaks = make_eval_step(model, 4, 0.3)(x)
    m1, stats = make_eval_step(model, 4, 0.3, with_stats=True)(x)
    assert stats.shape == (2, 4, 6) and stats.dtype == torch.float32
    np.testing.assert_array_equal(m0.numpy(), m1.numpy())
    areas, inter, extra = dp.unpack_mask_stats(stats.numpy())
    flat = m0.numpy().reshape(2, 4, -1).astype(np.int64)
    np.testing.assert_array_equal(areas, flat.sum(-1))
    np.testing.assert_array_equal(inter, np.einsum("bkp,bjp->bkj", flat, flat))
    np.testing.assert_array_equal(extra, peaks.numpy())
    assert 0 < areas.sum() < flat.size
    with pytest.raises(ValueError, match="with_stats"):
        make_eval_step(model, 4, None, with_stats=True)
