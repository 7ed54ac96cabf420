"""BBBC039 nuclei scores on the host (numpy): aggregated Jaccard (AJI),
pixel F1 and fast PQ.

The same semantics as ``pctrans_tpu/inference/metrics_bbbc.py:23-162``
(reference connectomics/inference/evaluation/metrics_bbbc.py: agg_jc_index:11,
pixel_f1:72, get_fast_pq:120, remap_label:216), matching quirks included,
with the pixel work in one contingency table, the (GT id, predicted id)
histogram of the image.  Each score has a core that takes that table
(``*_from_table``): the evaluator's tables are built on the card
(``ops/label_pairs.py``, K8), and :func:`remap_table` drops their empty ids
as :func:`remap_label` on both maps would.  The map-taking functions are
:func:`_contingency` and the core:

* AJI matches each GT instance, in id order, to the prediction of best
  IoU, treating predictions already used as zero intersection with union
  |gt|; when every IoU is zero the argmax still uses up the first
  prediction.  Unused predictions join the union at the end.
* PQ pairs every IoU above ``match_iou`` when it is at least 0.5 (pairs are
  then unique); below 0.5 a Hungarian pass maximises the total IoU first.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def _contingency(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Joint (gt, pred) label histogram [max(gt)+1, max(pred)+1], f64."""
    a = np.asarray(gt).ravel().astype(np.int64)
    b = np.asarray(pred).ravel().astype(np.int64)
    n_a, n_b = int(a.max()) + 1, int(b.max()) + 1
    joint = np.bincount(a * n_b + b, minlength=n_a * n_b)
    return joint.reshape(n_a, n_b).astype(np.float64)


def remap_label(pred: np.ndarray, by_size: bool = False) -> np.ndarray:
    """Relabel instances to contiguous ids 1..K (0 stays background)."""
    pred = np.asarray(pred)
    ids = np.unique(pred)
    ids = ids[ids != 0]
    if ids.size == 0:
        return pred
    if by_size:
        sizes = np.array([(pred == i).sum() for i in ids])
        ids = ids[np.argsort(-sizes, kind="stable")]
    new_pred = np.zeros(pred.shape, np.int32)
    for new_id, inst_id in enumerate(ids, start=1):
        new_pred[pred == inst_id] = new_id
    return new_pred


def remap_table(joint: np.ndarray) -> np.ndarray:
    """The table of ``remap_label(gt)`` against ``remap_label(pred)`` from
    the table of the raw maps: the empty rows and columns past 0 dropped,
    in order (``by_size=False`` keeps the ids' order)."""
    joint = np.asarray(joint)
    rows = np.flatnonzero(joint.sum(axis=1)[1:]) + 1
    cols = np.flatnonzero(joint.sum(axis=0)[1:]) + 1
    return joint[np.ix_(np.r_[0, rows], np.r_[0, cols])]


def agg_jc_index_from_table(joint: np.ndarray) -> float:
    """:func:`agg_jc_index` from the (gt, pred) table.  The greedy match
    visits only each GT row's nonzero, unused entries: every other IoU is
    zero, so the first maximum is among them unless all are zero, and then
    the argmax uses up the first prediction."""
    joint = np.asarray(joint, np.float64)
    n_gt, n_pred = joint.shape[0] - 1, joint.shape[1] - 1
    if n_gt == 0 or n_pred == 0:
        return 0.0
    gt_sizes, pred_sizes = joint.sum(axis=1).tolist(), joint.sum(axis=0)
    sizes = pred_sizes.tolist()
    rows, cols = np.nonzero(joint[1:, 1:])
    inters = joint[1:, 1:][rows, cols].tolist()
    starts = np.searchsorted(rows, np.arange(n_gt + 1)).tolist()
    cols = (cols + 1).tolist()
    used = [False] * (n_pred + 1)
    c = u = 0.0
    for g in range(1, n_gt + 1):
        m_size = gt_sizes[g]
        best, hit_inter, hit_union, hit = 0.0, 0.0, 0.0, 0
        for k in range(starts[g - 1], starts[g]):
            p = cols[k]
            if used[p]:
                continue
            inter = inters[k]
            union = m_size + sizes[p] - inter
            iou = inter / union
            if iou > best:
                best, hit_inter, hit_union, hit = iou, inter, union, p
        if hit == 0:                      # every IoU zero: the first prediction
            hit, hit_union = 1, m_size if used[1] else m_size + sizes[1]
        c += hit_inter
        u += hit_union
        used[hit] = True
    u += pred_sizes[1:][~np.asarray(used[1:])].sum()
    return float(c / u) if u > 0 else 0.0


def agg_jc_index(gt_ins: np.ndarray, pred: np.ndarray) -> float:
    """Aggregated Jaccard index of label maps with contiguous ids (call
    :func:`remap_label` first, as the eval loop does)."""
    return agg_jc_index_from_table(_contingency(gt_ins, pred))


def pixel_f1_from_table(joint: np.ndarray) -> float:
    """:func:`pixel_f1` from the (gt, pred) table."""
    joint = np.asarray(joint)
    tp = float(joint[1:, 1:].sum())
    fp = float(joint[0, 1:].sum())
    fn = float(joint[1:, 0].sum())
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def pixel_f1(gt_ins: np.ndarray, pred_ins: np.ndarray) -> float:
    """F1 of the foreground/background split."""
    return pixel_f1_from_table(_contingency(gt_ins, pred_ins))


def get_fast_pq(true: np.ndarray, pred: np.ndarray, match_iou: float = 0.5):
    """Panoptic-quality statistics ``[dq, sq, pq]`` and the pairing
    ``[paired_true, paired_pred, unpaired_true, unpaired_pred]``."""
    return fast_pq_from_table(_contingency(true, pred), match_iou)


def fast_pq_from_table(joint: np.ndarray, match_iou: float = 0.5):
    """:func:`get_fast_pq` from the (gt, pred) table."""
    if match_iou < 0.0:
        raise ValueError(f"match_iou {match_iou} < 0")
    joint = np.asarray(joint, np.float64)
    n_gt, n_pred = joint.shape[0] - 1, joint.shape[1] - 1
    if n_gt > 0 and n_pred > 0:
        inter = joint[1:, 1:]
        union = (joint[1:, :].sum(axis=1, keepdims=True)
                 + joint[:, 1:].sum(axis=0, keepdims=True) - inter)
        pairwise_iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    else:
        pairwise_iou = np.zeros((max(n_gt, 0), max(n_pred, 0)))

    if match_iou >= 0.5:
        paired_true, paired_pred = np.nonzero(pairwise_iou > match_iou)
        paired_iou = pairwise_iou[paired_true, paired_pred]
        paired_true, paired_pred = paired_true + 1, paired_pred + 1
    elif pairwise_iou.size:
        pt, pp = linear_sum_assignment(-pairwise_iou)
        piou = pairwise_iou[pt, pp]
        sel = piou > match_iou
        paired_true, paired_pred, paired_iou = pt[sel] + 1, pp[sel] + 1, piou[sel]
    else:
        paired_true = paired_pred = np.array([], dtype=np.int64)
        paired_iou = np.array([])

    true_set, pred_set = set(paired_true.tolist()), set(paired_pred.tolist())
    gt_present, pred_present = joint.sum(axis=1) > 0, joint.sum(axis=0) > 0
    unpaired_true = [i for i in range(1, n_gt + 1) if gt_present[i] and i not in true_set]
    unpaired_pred = [j for j in range(1, n_pred + 1)
                     if pred_present[j] and j not in pred_set]
    tp, fp, fn = len(paired_true), len(unpaired_pred), len(unpaired_true)
    dq = tp / (tp + 0.5 * fp + 0.5 * fn) if (tp + fp + fn) > 0 else 0.0
    sq = paired_iou.sum() / (tp + 1.0e-6)
    return [dq, sq, dq * sq], [list(paired_true), list(paired_pred),
                               unpaired_true, unpaired_pred]
