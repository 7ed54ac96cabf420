"""Trainer: the training and evaluation loop (mirror of
``pctrans_tpu/engine/trainer.py:55-304, 356-555``) over the port's train
step and evaluator, on one device.

* ``train()``: the iteration loop: prefetching loader -> ``make_train_step``
  -> every loss term and the LR to the monitor -> in-training
  ``validate()`` every SOLVER.ITERATION_VAL with ``checkpoint_best`` at the
  best primary metric (SBD; AJI for ``BBBC`` / ``synthetic_bbbc``) ->
  ``checkpoint_%06d.pth.tar`` every SOLVER.ITERATION_SAVE from
  SOLVER.START_SAVE on.  With SOLVER.SWA the parameters are averaged after
  every update from SWA.START_ITER on, every SWA.MERGE_ITER, and
  ``checkpoint_swa.pth.tar`` (the averaged weights, BatchNorm statistics
  refreshed over SWA.BN_UPDATE_ITER train batches) is written at each save
  point and at the end (``:255-277, 324-354``).  DATASET.TRANSFER_UINT8
  quantizes the images to uint8 on the host (``rint``, over
  TRANSFER_UINT8_RANGE) and sends the labels as uint8 (``:222-244``).
* ``eval_cvppp()``: SBD and |DiC| over the val split; ``test_bbbc()``: AJI,
  F1, detection F1 and PQ over the test split; both score the valid rows of
  each padded batch and append to ``INFERENCE.OUTPUT_PATH/logging.txt``.
* Resume (``:103-113``): a checkpoint restores strictly, else by matching
  keys and shapes; the loop starts at the restored iteration unless
  SOLVER.ITERATION_RESTART (then at MODEL.PRE_MODEL_ITER).

Not ported yet, and raising: ``test_cvppp`` (ROADMAP item 19).  The JAX
trainer's f16 image and int16 label transfer casts and its pipelined label
stream are workarounds for a slow host-to-TPU link and are not carried; the
in-training visualizer waits for TensorBoard (item 23).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CfgNode, build_model_config, save_all_cfg
from ..data.build import build_dataloader
from ..losses.criterion import SetCriterion, build_criterion_config
from ..models import PCTransModel
from ..models.resnet import convert_d2_r50_pickle
from ..utils.monitor import build_monitor
from . import checkpoint as ckpt
from .evaluator import Evaluator
from .solver import build_lr_scheduler, build_optimizer, build_solver_config, lr_factor
from .swa import SWAState, has_batch_norm, maybe_update_swa, refresh_batch_stats
from .train_step import make_train_step


def uint8_transfer(batch: Dict, input_range, wide_labels: bool = False) -> Dict:
    """DATASET.TRANSFER_UINT8 on the host (``pctrans_tpu/engine/trainer.py:
    222-244``): the images quantized to uint8 over ``input_range`` with
    ``rint``, the labels as uint8 unless ``wide_labels``; an id of 256 or
    more then raises.  The train step dequantizes with the same range."""
    lo, hi = input_range
    img = np.rint((np.asarray(batch["image"], np.float32) - lo)
                  * (255.0 / (hi - lo))).clip(0, 255).astype(np.uint8)
    label = np.asarray(batch["label"])
    if not wide_labels:
        if label.max() >= 256:
            raise ValueError("instance id >= 256 with TRANSFER_UINT8 labels; set "
                             "DATASET.WIDE_LABELS True to keep int32 label transfer "
                             "under uint8 images")
        label = label.astype(np.uint8)
    return {"image": img, "label": label}


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``; a CUDA device without a card raises."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Trainer: device {dev} asked for but no CUDA card "
                           "is available; pass device='cpu' to run on the CPU")
    return dev


class Trainer:
    def __init__(self, cfg: CfgNode, mode: str = "train",
                 checkpoint: Optional[str] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_config = build_model_config(cfg)
        self.max_instances = cfg.MODEL.MAX_INSTANCES
        self.output_dir = cfg.DATASET.OUTPUT_PATH
        self.model = PCTransModel(self.model_config,
                                  generator=torch.Generator().manual_seed(0))
        if cfg.MODEL.WEIGHTS and os.path.exists(cfg.MODEL.WEIGHTS):
            self.model.backbone.load_state_dict(convert_d2_r50_pickle(
                cfg.MODEL.WEIGHTS, self.model_config.backbone_depth))
        self.model.to(self.device)

        self.optimizer = self.scheduler = None
        if mode == "train":
            self.solver = build_solver_config(cfg)
            self.optimizer = build_optimizer(self.model, self.solver)
            self.scheduler = build_lr_scheduler(self.optimizer, self.solver)
        self.start_iter = int(cfg.MODEL.PRE_MODEL_ITER)
        if checkpoint:
            try:
                step = ckpt.restore_checkpoint(checkpoint, self.model,
                                               self.optimizer, self.scheduler)
            except (KeyError, RuntimeError, ValueError) as e:
                print(f"[checkpoint] strict restore failed ({type(e).__name__}); "
                      "falling back to a key-filtered partial load")
                step = ckpt.restore_partial(checkpoint, self.model,
                                            self.optimizer, self.scheduler)
            if not cfg.SOLVER.ITERATION_RESTART:
                self.start_iter = step

        self.top_k = int(cfg.INFERENCE.get("TOP_K", 0) or 0) or None
        self.dataset = ("bbbc" if cfg.DATASET.DATA_TYPE in ("BBBC", "synthetic_bbbc")
                        else "cvppp")
        self.evaluator = Evaluator(self.model, self.top_k, self.dataset)
        if mode == "train":
            generator = torch.Generator(device=self.device).manual_seed(
                int(cfg.SYSTEM.get("SEED", 42)))
            self._train_step = make_train_step(
                self.model, SetCriterion(build_criterion_config(cfg)),
                self.optimizer, self.scheduler, self.max_instances, generator,
                solver=self.solver, input_range=self.uint8_range)
            self.monitor = build_monitor(cfg)
            self.monitor.load_info(cfg)
            save_all_cfg(cfg, self.output_dir)
            self._train_data = build_dataloader(cfg, "train")
            self.train_loader = iter(self._train_data)
        self.total_iters = cfg.SOLVER.ITERATION_TOTAL
        self.best_val = float("-inf")
        self.swa = SWAState() if mode == "train" and cfg.SOLVER.SWA.ENABLED else None

    @property
    def uint8_range(self):
        return tuple(self.cfg.DATASET.get("TRANSFER_UINT8_RANGE", [0.0, 1.0]))

    def transfer_batch(self, batch: Dict) -> Dict:
        """The batch as sent to the device (:func:`uint8_transfer` under
        DATASET.TRANSFER_UINT8)."""
        if not self.cfg.DATASET.get("TRANSFER_UINT8", False):
            return {"image": batch["image"], "label": batch["label"]}
        return uint8_transfer(batch, self.uint8_range,
                              self.cfg.DATASET.get("WIDE_LABELS", False))

    def train(self) -> float:
        """Run iterations ``start_iter .. ITERATION_TOTAL - 1``; returns the
        wall time in seconds."""
        cfg = self.cfg
        t0 = time.perf_counter()
        val_every = int(cfg.SOLVER.get("ITERATION_VAL", 0) or 0)
        swa = cfg.SOLVER.SWA
        for it in range(self.start_iter, self.total_iters):
            metrics = self._train_step(self.transfer_batch(next(self.train_loader)))
            lr = self.solver.base_lr * lr_factor(it, self.solver)
            self.monitor.update(it, metrics, lr, total_iters=self.total_iters)
            if self.swa is not None:
                self.swa = maybe_update_swa(self.swa, dict(self.model.named_parameters()),
                                            it + 1, swa.START_ITER, swa.MERGE_ITER)
            if val_every and (it + 1) % val_every == 0:
                self.validate(it + 1)
            if (it + 1) % cfg.SOLVER.ITERATION_SAVE == 0 and \
                    (it + 1) >= cfg.SOLVER.START_SAVE:
                self.save_checkpoint(it)
                # checkpoint_swa at each save point too: the averaged
                # weights live in memory only between merges
                if self.swa is not None and self.swa.params is not None:
                    self.save_swa_checkpoint(it + 1)
        if self.swa is not None and self.swa.params is not None:
            self.save_swa_checkpoint(self.total_iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.train_loader.close()          # stops the producer thread
        self._train_data.close()           # and the item workers
        self.monitor.close()
        return time.perf_counter() - t0

    def validate(self, iteration: int) -> Dict[str, float]:
        """Score the val split, log it, and keep ``checkpoint_best`` at the
        best primary metric (SBD, or AJI for BBBC)."""
        if not hasattr(self, "_val_loader"):
            self._val_loader = build_dataloader(self.cfg, "val")
        name = f"val_{iteration:06d}"
        if self.dataset == "bbbc":
            res = self.test_bbbc(loader=iter(self._val_loader), model_name=name)
            primary = res["AJI"]
        else:
            res = self.eval_cvppp(loader=iter(self._val_loader), model_name=name)
            primary = res["SBD"]
        if hasattr(self, "monitor"):
            self.monitor.add_eval(iteration, res)
        if primary > self.best_val:
            self.best_val = primary
            ckpt.save_checkpoint(self.output_dir, self.model, self.optimizer,
                                 self.scheduler, iteration, is_best=True)
        return res

    def save_checkpoint(self, iteration: int, is_best: bool = False) -> str:
        return ckpt.save_checkpoint(self.output_dir, self.model, self.optimizer,
                                    self.scheduler, iteration + 1, is_best)

    def save_swa_checkpoint(self, iteration: int) -> str:
        """``checkpoint_swa.pth.tar``: the averaged parameters, with the
        BatchNorm statistics refreshed under them over SWA.BN_UPDATE_ITER
        train batches (which the training stream then skips, as in the JAX
        trainer).  The live model gets its weights and statistics back."""
        live = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(self.swa.params[name])
        try:
            if has_batch_norm(self.model):
                refresh_batch_stats(self.model, self.train_loader,
                                    self.cfg.SOLVER.SWA.BN_UPDATE_ITER)
            return ckpt.save_checkpoint(self.output_dir, self.model, self.optimizer,
                                        self.scheduler, iteration, name="checkpoint_swa")
        finally:
            self.model.load_state_dict(live)

    def predict_labels(self, images, dataset: Optional[str] = None):
        """images [B, H, W, 3] -> int16 instance label maps [B, H, W] by
        ``dataset``'s protocol ("cvppp" or "bbbc"; by default the config's)."""
        if dataset in (None, self.dataset):
            return self.evaluator.predict_labels(images)
        return Evaluator(self.model, self.top_k, dataset).predict_labels(images)

    def _scored(self, score, mode: str, loader):
        """``score`` over ``loader``, or over a ``mode`` loader built and
        closed here."""
        if loader is not None:
            return score(loader)
        built = build_dataloader(self.cfg, mode)
        try:
            return score(built)
        finally:
            built.close()

    def eval_cvppp(self, loader=None, model_name: str = "model") -> Dict[str, float]:
        res = self._scored(self.evaluator.eval_cvppp, "val", loader)
        self._append_log(model_name, [res["SBD"], res["absDiffFG"]])
        return res

    def test_cvppp(self, loader=None, submission: Optional[str] = None) -> str:
        raise NotImplementedError("test_cvppp (the CVPPP test set and its "
                                  "submission.h5): ROADMAP item 19")

    def test_bbbc(self, loader=None, model_name: str = "model") -> Dict[str, float]:
        res = self._scored(self.evaluator.test_bbbc, "test", loader)
        self._append_log(model_name, [res["AJI"], res["F1"], res["detF1"], res["PQ"]])
        return res

    def _append_log(self, model_name: str, values) -> None:
        out = self.cfg.INFERENCE.OUTPUT_PATH
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "logging.txt"), "a") as f:
            f.write(model_name + "\n")
            f.write(" ".join(str(v) for v in values) + "\n")
