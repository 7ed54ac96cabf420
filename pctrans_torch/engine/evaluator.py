"""Evaluator of the CVPPP and BBBC protocols (mirror of the JAX
``Trainer.predict_labels`` / ``eval_cvppp`` / ``test_bbbc``,
``pctrans_tpu/engine/trainer.py:406-465, 480-555``).

Labels come from the device postprocess
(``pctrans_torch.inference.device_postprocess``): the eval step binarizes
the masks and computes their statistics on the masks' device, the host
fetches the packed statistics, checks TOP_K's lossiness on the peak logits
(a lossy batch runs again with all queries), clusters, and the merge and
paint run on the device; the label map is the one array of pixels that
comes back.  Scores: SBD and |DiC| (``metrics_cvppp``) for CVPPP; AJI,
pixel F1, detection F1 and PQ (``metrics_bbbc``) for BBBC.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..inference import metrics_bbbc as mb
from ..inference import metrics_cvppp as mc
from ..inference.device_postprocess import DevicePostprocessor, unpack_mask_stats
from ..models import PCTransModel
from .eval_step import make_eval_step

THRESHOLDS = {"cvppp": 0.69, "bbbc": 0.05}     # mask probability, per recipe


class Evaluator:
    """Serves one recipe's eval protocol with one model on one device."""

    def __init__(self, model: PCTransModel, top_k: Optional[int] = 50,
                 dataset: str = "cvppp"):
        self.num_queries = model.config.num_queries
        self.device = next(model.parameters()).device
        self.threshold = THRESHOLDS[dataset]
        self.postprocessor = DevicePostprocessor(dataset)
        self._step = make_eval_step(model, top_k or None, self.threshold, with_stats=True)
        self._full_step = make_eval_step(model, None, self.threshold, with_stats=True)
        self.forwards = 0          # forwards run, full-Q re-runs included

    def masks_and_stats(self, images: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        """images [B, H, W, 3] -> (u8 masks [B, K, H, W] on the device, their
        packed statistics [B, K, K+2] on the host)."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        masks, stats = self._step(x)
        self.forwards += 1
        stats = stats.cpu().numpy()
        if masks.shape[1] < self.num_queries:
            peaks = unpack_mask_stats(stats)[2]
            with np.errstate(over="ignore"):        # exp(88.8) is inf in f32
                lossy = (1.0 / (1.0 + np.exp(-peaks[:, -1])) > self.threshold).any()
            if lossy:
                # TOP_K was provably lossy: run again with all queries
                masks, stats = self._full_step(x)
                self.forwards += 1
                stats = stats.cpu().numpy()
        return masks, stats

    def label_masks(self, masks: torch.Tensor, stats: np.ndarray) -> np.ndarray:
        """The device postprocess of :meth:`masks_and_stats`'s output ->
        int16 label maps [B, H, W] on the host."""
        areas, inter, _ = unpack_mask_stats(stats)
        return self.postprocessor(masks, areas, inter)

    def predict_masks(self, images: np.ndarray) -> np.ndarray:
        """images [B, H, W, 3] -> u8 masks [B, K, H, W] on the host."""
        return self.masks_and_stats(images)[0].cpu().numpy()

    def predict_labels(self, images: np.ndarray) -> np.ndarray:
        """images [B, H, W, 3] -> int16 instance label maps [B, H, W]."""
        return self.label_masks(*self.masks_and_stats(images))

    def eval_cvppp(self, batches: Iterable[Dict[str, np.ndarray]]
                   ) -> Dict[str, float]:
        """Mean SBD and |DiC| over batches {"image", "label"[, "fg"]}.  A
        batch padded to full size (``_num_valid``, ``data/build.py``) is
        scored on its valid rows only."""
        sbd_all, diff_all, n = 0.0, 0.0, 0
        for batch in batches:
            labels = self.predict_labels(batch["image"])
            for b in range(int(batch.get("_num_valid", labels.shape[0]))):
                seg = labels[b].astype(np.uint16)
                if "fg" in batch:
                    seg = seg * (batch["fg"][b] > 0).astype(np.uint16)
                gt = batch["label"][b].astype(np.uint16)
                sbd_all += mc.SymmetricBestDice(seg, gt)
                diff_all += abs(mc.DiffFGLabels(seg, gt))
                n += 1
        return {"SBD": sbd_all / max(n, 1), "absDiffFG": diff_all / max(n, 1)}

    def test_bbbc(self, batches: Iterable[Dict[str, np.ndarray]]) -> Dict[str, float]:
        """Mean and std of AJI, pixel F1, detection F1 and PQ (match IoU
        0.5) over batches {"image", "label"}, on the valid rows of each."""
        scores = {"AJI": [], "F1": [], "detF1": [], "PQ": []}
        for batch in batches:
            labels = self.predict_labels(batch["image"])
            for b in range(int(batch.get("_num_valid", labels.shape[0]))):
                gt = mb.remap_label(batch["label"][b], by_size=False)
                pred = mb.remap_label(labels[b], by_size=False)
                scores["AJI"].append(mb.agg_jc_index(gt, pred))
                scores["F1"].append(mb.pixel_f1(gt, pred))
                dq, _, pq = mb.get_fast_pq(gt, pred, match_iou=0.5)[0]
                scores["detF1"].append(dq)
                scores["PQ"].append(pq)
        res = {}
        for k, v in scores.items():
            res[k] = float(np.mean(v))
            res[f"{k}_std"] = float(np.std(v))
        return res
