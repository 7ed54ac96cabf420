"""CVPPP evaluator (mirror of ``Trainer.predict_labels`` / ``eval_cvppp``,
``pctrans_tpu/engine/trainer.py:454-499``).

Labels come from the numpy postprocess
``pctrans_torch.inference.postprocess.instance_inference_cvppp`` applied to
the eval step's u8 masks: {0, 1} against its 0.69 threshold binarizes
exactly as the device masks did.  Scores are SBD and |DiC| from
``pctrans_torch.inference.metrics_cvppp``.  The JAX package's
device-resident postprocess is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..inference import metrics_cvppp as mc
from ..inference.postprocess import instance_inference_cvppp
from ..models import PCTransModel
from .eval_step import make_eval_step

CVPPP_THRESHOLD = 0.69


class Evaluator:
    """Serves the CVPPP eval protocol with one model on one device."""

    def __init__(self, model: PCTransModel, top_k: Optional[int] = 50):
        self.num_queries = model.config.num_queries
        self.device = next(model.parameters()).device
        thr = CVPPP_THRESHOLD
        self._step = make_eval_step(model, top_k or None, thr)
        self._full_step = make_eval_step(model, None, thr)
        self.forwards = 0          # forwards run, full-Q re-runs included

    def predict_masks(self, images: np.ndarray) -> np.ndarray:
        """images [B, H, W, 3] -> u8 masks [B, K, H, W] on the host."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        masks, peaks = self._step(x)
        self.forwards += 1
        if masks.shape[1] < self.num_queries:
            peak_p = torch.sigmoid(peaks[:, -1])
            if bool((peak_p > CVPPP_THRESHOLD).any()):
                # TOP_K was provably lossy: re-run with all queries
                masks, _ = self._full_step(x)
                self.forwards += 1
        return masks.cpu().numpy()

    def predict_labels(self, images: np.ndarray) -> np.ndarray:
        """images [B, H, W, 3] -> int16 instance label maps [B, H, W]."""
        masks = self.predict_masks(images)
        return np.stack([instance_inference_cvppp(m.astype(np.float32),
                                                  CVPPP_THRESHOLD)
                         for m in masks])

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
