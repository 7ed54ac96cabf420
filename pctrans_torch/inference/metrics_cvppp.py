"""CVPPP leaf-segmentation scores on the host (numpy): SBD and DiC.

The same semantics as ``pctrans_tpu/inference/metrics_cvppp.py`` (reference
lib/evaluate/CVPPP_evaluate.pyx: BestDice:45, SymmetricBestDice:147,
DiffFGLabels:25), computed from one label-pair contingency table (the
``*_from_table`` cores take it; the evaluator's tables are built on the
card, ``ops/label_pairs.py``, K8):

* labels are consecutive; the lowest label of each map is background;
* absent intermediate labels still count in the BestDice denominator;
* SBD = min(BestDice(in, gt), BestDice(gt, in));
* DiffFGLabels = (max(in) - min(in)) - (max(gt) - min(gt)).
"""

from __future__ import annotations

import numpy as np


def _joint(in_label: np.ndarray, gt_label: np.ndarray) -> np.ndarray:
    """joint[i, j] = |in==i & gt==j|, [max(in)+1, max(gt)+1]."""
    a = in_label.ravel().astype(np.int64)
    b = gt_label.ravel().astype(np.int64)
    n_in, n_gt = int(a.max()) + 1, int(b.max()) + 1
    joint = np.bincount(a * n_gt + b, minlength=n_in * n_gt)
    return joint.reshape(n_in, n_gt)


def _pairwise_dice(joint: np.ndarray) -> np.ndarray:
    """dice[i, j] = 2|in==i & gt==j| / (|in==i| + |gt==j|) for all label pairs."""
    joint = np.asarray(joint, np.float64)
    denom = joint.sum(axis=1)[:, None] + joint.sum(axis=0)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 1e-8, 2.0 * joint / np.maximum(denom, 1e-12), 0.0)


def _id_range(sizes: np.ndarray):
    """(min, max) of the ids present in a map, from its per-id pixel counts."""
    present = np.flatnonzero(sizes)
    return int(present[0]), int(present[-1])


def _best_dice(dice: np.ndarray, in_range, gt_range) -> float:
    """Mean over foreground in-labels (min+1..max) of the best dice against
    any foreground gt label."""
    (min_in, max_in), (min_gt, max_gt) = in_range, gt_range
    if max_in == min_in:                  # only background predicted
        return 0.0
    rows = np.arange(min_in + 1, max_in + 1)
    cols = np.arange(min_gt + 1, max_gt + 1)
    best = (dice[np.ix_(rows, cols)].max(axis=1) if len(cols)
            else np.zeros(len(rows)))
    return float(best.sum() / (max_in - min_in))


def symmetric_best_dice_from_table(joint: np.ndarray) -> float:
    """:func:`SymmetricBestDice` from the (in, gt) table ``joint[i, j] =
    |in==i & gt==j|``, which may have more rows and columns than ids."""
    joint = np.asarray(joint)
    in_range = _id_range(joint.sum(axis=1))
    gt_range = _id_range(joint.sum(axis=0))
    dice = _pairwise_dice(joint)
    return min(_best_dice(dice, in_range, gt_range),
               _best_dice(dice.T, gt_range, in_range))


def diff_fg_labels_from_table(joint: np.ndarray) -> float:
    """:func:`DiffFGLabels` from the (in, gt) table."""
    joint = np.asarray(joint)
    (min_in, max_in), (min_gt, max_gt) = (_id_range(joint.sum(axis=1)),
                                          _id_range(joint.sum(axis=0)))
    return float((max_in - min_in) - (max_gt - min_gt))


def SymmetricBestDice(in_label: np.ndarray, gt_label: np.ndarray) -> float:
    return symmetric_best_dice_from_table(_joint(np.asarray(in_label), np.asarray(gt_label)))


def DiffFGLabels(in_label: np.ndarray, gt_label: np.ndarray) -> float:
    in_label, gt_label = np.asarray(in_label), np.asarray(gt_label)
    return float((int(in_label.max()) - int(in_label.min()))
                 - (int(gt_label.max()) - int(gt_label.min())))
