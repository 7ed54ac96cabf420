"""Eval step (mirror of ``pctrans_tpu/engine/state.py:117-195``, binarized
branch).

``make_eval_step(model, top_k, threshold)(images)`` widens the images to
f32, runs the forward (bf16 autocast when the config asks for it), keeps
the ``top_k`` queries with the highest peak logit, and upsamples and
binarizes them at the input size in one K4 launch:
``(masks_u8 [B, K, H, W], peaks [B, K] f32)``.  With ``with_stats`` the
same call also computes the masks' areas, K x K intersections and peak
logits on the device, packed into one f32 array (K7,
``ops/mask_stats.packed_mask_stats``): ``(masks_u8, stats [B, K, K+2])``.

The top-k filter is exact while at most K queries clear the threshold:
bilinear upsampling is a convex combination, so a query's upsampled peak
never exceeds its stride-4 peak.  ``peaks[:, -1]`` above the threshold
logit means the filter was lossy; the evaluator then re-runs the batch with
all queries.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..models import PCTransModel
from ..ops.mask_stats import packed_mask_stats
from ..ops.resize_binarize import resize_bilinear_binarize


def make_eval_step(model: PCTransModel, top_k: Optional[int],
                   threshold: Optional[float], with_stats: bool = False) -> Callable:
    if threshold is None:
        raise ValueError("the eval step binarizes: it needs a threshold"
                         + (" (with_stats requires one)" if with_stats else ""))
    logit_t = math.log(threshold / (1.0 - threshold))

    @torch.inference_mode()
    def eval_step(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # at every call: a train step between two evals leaves train mode on
        model.eval()
        images = images.float()
        masks = model(images)["pred_masks"].float()  # [B, Q, h, w]
        peak = masks.amax(dim=(2, 3))
        if top_k is not None and top_k < masks.shape[1]:
            peaks, idx = torch.topk(peak, top_k, dim=1)
            masks = torch.take_along_dim(masks, idx[:, :, None, None], dim=1)
        else:
            peaks = peak
        masks_u8 = resize_bilinear_binarize(masks, tuple(images.shape[1:3]),
                                            logit_t)
        if with_stats:
            return masks_u8, packed_mask_stats(masks_u8, extra=peaks)
        return masks_u8, peaks

    return eval_step
