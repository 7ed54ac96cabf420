"""The PyTorch port's eval step and CVPPP evaluator on the CPU (twins): the
TOP_K lossiness check and full-Q re-run (``engine/trainer.py:386-396``),
the label chain, and the bf16 autocast forward."""

import dataclasses

import numpy as np
import pytest
import torch

from pctrans_torch.config import ModelConfig
from pctrans_torch.data.synthetic import make_blob_image
from pctrans_torch.engine.evaluator import Evaluator
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
