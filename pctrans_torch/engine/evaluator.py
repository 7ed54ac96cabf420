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

``eval_cvppp``, ``test_bbbc`` and ``cvppp_submission`` label through
:meth:`Evaluator._label_pipeline`, the JAX eval loops' five stages, each one
batch behind the one before (``pctrans_tpu/engine/trainer.py:423-483``): the
forward of batch n+1 is queued while the host clusters batch n and the copies
of statistics and label maps land.  The labels are those of the serial
:meth:`Evaluator.predict_labels`, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..inference import metrics_bbbc as mb
from ..inference import metrics_cvppp as mc
from ..inference.device_postprocess import (DevicePostprocessor, copy_to_host_async,
                                            pipeline_batches, unpack_mask_stats)
from ..inference.postprocess import merge_func
from ..models import PCTransModel
from ..utils import tracing
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
        # the label pipeline's host copies run on a stream of their own
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)

    def _images(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)

    def _lossy(self, masks: torch.Tensor, stats: np.ndarray) -> bool:
        """TOP_K was provably lossy: its lowest kept peak clears the
        threshold."""
        if masks.shape[1] >= self.num_queries:
            return False
        peaks = unpack_mask_stats(stats)[2]
        with np.errstate(over="ignore"):        # exp(88.8) is inf in f32
            return bool((1.0 / (1.0 + np.exp(-peaks[:, -1])) > self.threshold).any())

    def masks_and_stats(self, images: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        """images [B, H, W, 3] -> (u8 masks [B, K, H, W] on the device, their
        packed statistics [B, K, K+2] on the host)."""
        x = self._images(images)
        masks, stats = self._step(x)
        self.forwards += 1
        with tracing.span("wait.stats"):
            stats = stats.cpu().numpy()
        if self._lossy(masks, stats):
            # run again with all queries
            masks, stats = self._full_step(x)
            self.forwards += 1
            with tracing.span("wait.stats"):
                stats = stats.cpu().numpy()
        return masks, stats

    def label_masks(self, masks: torch.Tensor, stats: np.ndarray) -> np.ndarray:
        """The device postprocess of :meth:`masks_and_stats`'s output ->
        int16 label maps [B, H, W] on the host."""
        areas, inter, _ = unpack_mask_stats(stats)
        return self.postprocessor(masks, areas, inter)

    def predict_masks(self, images: np.ndarray) -> np.ndarray:
        """images [B, H, W, 3] -> u8 masks [B, K, H, W] on the host."""
        masks = self.masks_and_stats(images)[0]
        with tracing.span("wait.masks"):
            return masks.cpu().numpy()

    def predict_labels(self, images: np.ndarray) -> np.ndarray:
        """images [B, H, W, 3] -> int16 instance label maps [B, H, W]."""
        return self.label_masks(*self.masks_and_stats(images))

    # ------------------------------------------------ the label pipeline
    def _dispatch(self, images: np.ndarray):
        """Stage 0: queue the forward, binarize and statistics, and start the
        statistics' copy to the host."""
        x = self._images(images)
        masks, stats = self._step(x)
        self.forwards += 1
        return x, masks, copy_to_host_async(stats, self._copy_stream, "stats")

    def _cluster(self, handles):
        """Stage 1: the TOP_K lossiness check on the landed statistics (a
        lossy batch runs again at full Q, fetched at once), the greedy
        clustering and the postprocess's device tail; CVPPP's merged
        statistics start their copy."""
        x, masks, stats = handles
        stats = stats.wait().numpy()
        if self._lossy(masks, stats):
            with tracing.span("eval.rerun"):
                masks, stats = self._full_step(x)
                self.forwards += 1
                with tracing.span("wait.stats"):
                    stats = stats.cpu().numpy()
        areas, inter, _ = unpack_mask_stats(stats)
        pending = self.postprocessor.start(masks, areas, inter)
        if isinstance(pending, torch.Tensor):
            return pending
        merged, m_stats, clusters = pending
        return merged, copy_to_host_async(m_stats, self._copy_stream, "merged_stats"), clusters

    def _label_pipeline(self, batches: Iterable[Dict[str, np.ndarray]]
                        ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        """(batch, int16 label maps [B, H, W]) for each batch, in order,
        through five stages one batch apart: dispatch; lossiness check,
        clustering and the device tail; CVPPP's NMS and the paint, which
        starts the label map's copy; a pass-through lag that gives that copy
        a batch interval to land; collect.  Each stage but the lag is span
        ``eval.<stage>`` keyed by the batch's index."""
        def staged(name, fn):
            def stage(kb, value):
                with tracing.span(name, key=kb[0]):
                    return fn(kb[1], value)
            return stage

        for (_, batch), labels in pipeline_batches(
                enumerate(batches),
                staged("eval.dispatch", lambda b, _: self._dispatch(b["image"])),
                staged("eval.cluster", lambda b, h: self._cluster(h)),
                staged("eval.finish", lambda b, p: copy_to_host_async(
                    self.postprocessor.finish(p), self._copy_stream, "labels")),
                lambda kb, lab: lab,
                staged("eval.collect", lambda b, lab: lab.wait().numpy())):
            yield batch, labels

    def eval_cvppp(self, batches: Iterable[Dict[str, np.ndarray]]
                   ) -> Dict[str, float]:
        """Mean SBD and |DiC| over batches {"image", "label"[, "fg"]}.  A
        batch padded to full size (``_num_valid``, ``data/build.py``) is
        scored on its valid rows only."""
        sbd_all, diff_all, n = 0.0, 0.0, 0
        for k, (batch, labels) in enumerate(self._label_pipeline(batches)):
            with tracing.span("eval.score", key=k):
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
        for k, (batch, labels) in enumerate(self._label_pipeline(batches)):
            with tracing.span("eval.score", key=k):
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

    def cvppp_submission(self, batches: Iterable[Dict[str, np.ndarray]],
                         plants: Iterable[str]) -> Iterator[Tuple[str, np.ndarray]]:
        """(plant, u8 label map) for each valid row of the CVPPP test batches
        {"image", "fg"}: the pipeline's labels masked by the provided
        foreground and cleaned by ``merge_func``
        (``pctrans_tpu/engine/trainer.py:501-533``); the k-th row takes the
        k-th of ``plants``."""
        plants = iter(plants)
        for batch, labels in self._label_pipeline(batches):
            for b in range(int(batch.get("_num_valid", labels.shape[0]))):
                seg = labels[b].astype(np.int32)
                if "fg" in batch:
                    seg = seg * (batch["fg"][b] > 0).astype(np.int32)
                yield next(plants), merge_func(seg).astype(np.uint8)
