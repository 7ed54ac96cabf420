"""The port's numpy host modules against the JAX package's: the synthetic
scene generator, the CVPPP instance postprocess and the CVPPP scores.
Each must be bit-equal to its counterpart on the same inputs (exact
comparisons: both run the same f32/f64 numpy arithmetic)."""

import numpy as np
import pytest

from pctrans_torch.data import synthetic as port_synthetic
from pctrans_torch.inference import metrics_cvppp as port_metrics
from pctrans_torch.inference import postprocess as port_post
from pctrans_tpu.data import synthetic as jax_synthetic
from pctrans_tpu.inference import metrics_cvppp as jax_metrics
from pctrans_tpu.inference import postprocess as jax_post


@pytest.mark.parametrize("seed,size,kw", [
    (0, (53, 50), {}),
    (1, (64, 96), {"n_instances": (2, 4)}),
    (2, (80, 70), {"n_instances": (10, 20), "radius_px": (3.0, 6.0)}),
])
def test_make_blob_image_matches(seed, size, kw):
    img_p, lab_p = port_synthetic.make_blob_image(np.random.RandomState(seed), size, **kw)
    img_j, lab_j = jax_synthetic.make_blob_image(np.random.RandomState(seed), size, **kw)
    np.testing.assert_array_equal(img_p, img_j)
    np.testing.assert_array_equal(lab_p, lab_j)
    assert lab_p.max() >= 1


def _mask_probs(seed, Q=24, hw=(60, 70)):
    """Soft disc masks; every three queries share a jittered centre, so
    near-duplicates cluster and overlapping ones meet the NMS; the smallest
    discs fall under the minimum area."""
    rng = np.random.RandomState(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    centres = rng.uniform([0, 0], [H, W], size=(Q // 3, 2))
    probs = []
    for q in range(Q):
        cy, cx = centres[q % len(centres)] + rng.randn(2) * 2.0
        d = np.hypot(yy - cy, xx - cx) - rng.uniform(2.0, 15.0)
        probs.append(1.0 / (1.0 + np.exp(d + rng.randn(H, W) * 0.5)))
    return np.stack(probs).astype(np.float32)


@pytest.mark.parametrize("binary", [False, True], ids=["probs", "u8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instance_inference_cvppp_matches(seed, binary):
    probs = _mask_probs(seed)
    if binary:            # the evaluator's input: u8 masks binarized at 0.69
        probs = (probs > 0.69).astype(np.uint8).astype(np.float32)
    lab_p = port_post.instance_inference_cvppp(probs, 0.69)
    lab_j = jax_post.instance_inference_cvppp(probs, 0.69)
    assert lab_p.dtype == lab_j.dtype == np.int16
    np.testing.assert_array_equal(lab_p, lab_j)
    assert lab_p.max() >= 2


def test_instance_inference_cvppp_empty():
    probs = np.full((5, 12, 10), 0.5, np.float32)
    np.testing.assert_array_equal(port_post.instance_inference_cvppp(probs),
                                  jax_post.instance_inference_cvppp(probs))


@pytest.mark.parametrize("case", ["shifted", "missing_labels", "background_only",
                                  "offset_background"])
def test_cvppp_scores_match(case):
    rng = np.random.RandomState(3)
    _, gt = port_synthetic.make_blob_image(rng, (64, 60), n_instances=(4, 8))
    pred = np.roll(gt, (2, -3), axis=(0, 1))
    if case == "missing_labels":         # gaps still count in the denominator
        pred = np.where(pred == 2, 0, pred)
    elif case == "background_only":
        pred = np.zeros_like(gt)
    elif case == "offset_background":    # the lowest label is background
        pred = pred + 3
    pred, gt = pred.astype(np.uint16), gt.astype(np.uint16)
    assert port_metrics.SymmetricBestDice(pred, gt) == \
        jax_metrics.SymmetricBestDice(pred, gt)
    assert port_metrics.SymmetricBestDice(gt, pred) == \
        jax_metrics.SymmetricBestDice(gt, pred)
    assert port_metrics.DiffFGLabels(pred, gt) == jax_metrics.DiffFGLabels(pred, gt)
