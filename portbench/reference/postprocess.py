"""Instance postprocess on the host (numpy): dice clustering, mask NMS,
argmax painting.

The chains of ``pctrans_tpu/inference/postprocess.py`` (reference
``MaskFormer.instance_inference``, arch/maskformer.py:267-431), with the
same f32 arithmetic so its label maps are bit-equal (held so by a test):

  CVPPP: prob > 0.69 -> drop area <= 40 -> greedy dice clustering (dice >
  0.5, merge = mean of members, re-binarized at 0.6) -> mask NMS with
  MMI >= 0.72 and area-ratio scores -> paint by ascending area with argmax
  (first max wins on overlap).

  BBBC: prob > 0.05 -> drop area <= 40 -> greedy dice clustering (dice >
  0.15, merged masks stay fractional) -> paint by ascending area.

The greedy loops work on [K] / [K, K] statistics (``clusters_from_dice``,
``nms_keep``), which the device path
(``pctrans_torch.inference.device_postprocess``) shares; this module is the
numpy oracle that it is held against.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _flat_stats(masks: np.ndarray):
    """Areas [N] and pairwise intersections [N, N] of binary masks, f32."""
    flat = masks.reshape(masks.shape[0], -1).astype(np.float32)
    return flat.sum(axis=1), flat @ flat.T


def dice_from_stats(areas: np.ndarray, inter: np.ndarray) -> np.ndarray:
    """dice[i, j] = (2|i&j| + 1) / (|i| + |j| + 1) from areas [K] and
    intersections [K, K] (maskformer.py:392-401), in f32."""
    a = areas.astype(np.float32)
    return (2.0 * inter.astype(np.float32) + 1.0) / (a[:, None] + a[None, :] + 1.0)


def pairwise_dice_binary(masks: np.ndarray) -> np.ndarray:
    """Pairwise dice of binary (or 0/1 float) masks [N, H, W]."""
    return dice_from_stats(*_flat_stats(masks))


def clusters_from_dice(dice: np.ndarray, thres1: float) -> List[List[int]]:
    """Greedy dice clustering (maskformer.py:403-418).

    Indices are taken in order; one already absorbed into an earlier
    cluster seeds none, but may join later clusters as a member.
    """
    clustered: set = set()
    clusters: List[List[int]] = []
    for i in range(dice.shape[0]):
        if i in clustered:
            continue
        members = np.where(dice[i] > thres1)[0].tolist()
        clustered.update(members)
        clusters.append(members)
    return clusters


def mask_post(inst_masks: np.ndarray, thres1: float, thres2: float,
              bd_flag: bool = False, dice: Optional[np.ndarray] = None) -> np.ndarray:
    """Greedy dice clustering and mean merge (maskformer.py:403-431); with
    ``bd_flag`` each merged mask is re-binarized at ``thres2``."""
    if dice is None:
        dice = pairwise_dice_binary(inst_masks)
    merged = []
    for members in clusters_from_dice(dice, thres1):
        m = inst_masks[members].mean(axis=0)
        if bd_flag:
            m = (m > thres2).astype(inst_masks.dtype)
        merged.append(m)
    return np.stack(merged)


def _mmi(area_a: float, area_b: float, intersect: float) -> float:
    if area_a == 0 or area_b == 0:
        area_a += 1e-5
        area_b += 1e-5
    return max(intersect / area_a, intersect / area_b)


def nms_keep(areas: np.ndarray, inter: np.ndarray, scores: np.ndarray,
             thres: float) -> List[int]:
    """Greedy suppression by max-mask-intersection (maskformer.py:357-390);
    the kept indices in keep order."""
    order = np.argsort(scores)[::-1].tolist()
    suppressed = np.zeros(len(order), dtype=bool)
    keep: List[int] = []
    for i, idx in enumerate(order):
        if suppressed[idx]:
            continue
        keep.append(idx)
        for jdx in order[i + 1:]:
            if not suppressed[jdx] and _mmi(areas[idx], areas[jdx],
                                            inter[idx, jdx]) >= thres:
                suppressed[jdx] = True
    return keep


def paint_ascending_area(masks: np.ndarray) -> np.ndarray:
    """int16 label map: masks sorted by ascending area behind a zero
    background, argmax-painted (maskformer.py:298-304), so the smallest
    overlapping instance takes the pixel."""
    order = np.argsort(masks.reshape(masks.shape[0], -1).sum(axis=1),
                       kind="stable")
    stack = np.concatenate([np.zeros((1,) + masks.shape[1:], masks.dtype),
                            masks[order]])
    return np.argmax(stack, axis=0).astype(np.int16)


def _above_min_area(probs: np.ndarray, threshold: float, min_area: float):
    pred = (probs > threshold).astype(np.float32)
    return pred[pred.reshape(pred.shape[0], -1).sum(axis=1) > min_area]


def instance_inference_cvppp(
    probs: np.ndarray,
    threshold: float = 0.69,
    min_area: float = 40.0,
    cluster_thres1: float = 0.5,
    cluster_thres2: float = 0.6,
    nms_thres: float = 0.72,
) -> np.ndarray:
    """probs: mask probabilities [Q, H, W] -> int16 label map [H, W]."""
    pred = _above_min_area(probs, threshold, min_area)
    if pred.shape[0] == 0:
        return np.zeros(probs.shape[1:], np.int16)
    pred = mask_post(pred, cluster_thres1, cluster_thres2, bd_flag=True)
    areas, inter = _flat_stats(pred)
    scores = areas / max(areas.max(), 1e-5)
    return paint_ascending_area(pred[nms_keep(areas, inter, scores, nms_thres)])


def instance_inference_bbbc(
    probs: np.ndarray,
    threshold: float = 0.05,
    min_area: float = 40.0,
    cluster_thres1: float = 0.15,
    cluster_thres2: float = 0.25,
) -> np.ndarray:
    """probs: mask probabilities [Q, H, W] -> int16 label map [H, W]."""
    pred = _above_min_area(probs, threshold, min_area)
    if pred.shape[0] == 0:
        return np.zeros(probs.shape[1:], np.int16)
    return paint_ascending_area(mask_post(pred, cluster_thres1, cluster_thres2))
