"""Trainer: the training and evaluation loop (mirror of
``pctrans_tpu/engine/trainer.py:55-304, 356-499, 557-562``) over the port's
train step and CVPPP evaluator, on one device.

* ``train()``: the iteration loop: prefetching loader -> ``make_train_step``
  -> every loss term and the LR to the monitor -> in-training
  ``validate()`` every SOLVER.ITERATION_VAL with ``checkpoint_best`` at the
  best SBD -> ``checkpoint_%06d.pth.tar`` every SOLVER.ITERATION_SAVE from
  SOLVER.START_SAVE on.
* ``eval_cvppp()``: SBD and |DiC| over the val split, scored on the valid
  rows of each padded batch, appended to ``INFERENCE.OUTPUT_PATH/logging.txt``.
* Resume (``:103-113``): a checkpoint restores strictly, else by matching
  keys and shapes; the loop starts at the restored iteration unless
  SOLVER.ITERATION_RESTART (then at MODEL.PRE_MODEL_ITER).

Not ported yet, and raising: SWA (ROADMAP item 14a), DATASET.TRANSFER_UINT8
(15a), ``test_cvppp`` (19), ``test_bbbc`` (21).  The JAX trainer's f16 image
and int16 label transfer casts are workarounds for a slow host-to-TPU link
and are not carried; the in-training visualizer waits for TensorBoard
(item 23).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from ..config import CfgNode, build_model_config, save_all_cfg
from ..data.build import build_dataloader
from ..losses.criterion import SetCriterion, build_criterion_config
from ..models import PCTransModel
from ..models.resnet import convert_d2_r50_pickle
from ..utils.monitor import build_monitor
from . import checkpoint as ckpt
from .evaluator import Evaluator
from .solver import (build_lr_scheduler, build_optimizer, build_solver_config,
                     warmup_poly_factor)
from .train_step import make_train_step


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
        if cfg.SOLVER.SWA.ENABLED:
            raise NotImplementedError("SOLVER.SWA: not ported yet (ROADMAP item 14a)")
        if cfg.DATASET.get("TRANSFER_UINT8", False):
            raise NotImplementedError(
                "DATASET.TRANSFER_UINT8: not ported yet (ROADMAP item 15a)")
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

        top_k = int(cfg.INFERENCE.get("TOP_K", 0) or 0)
        self.evaluator = Evaluator(self.model, top_k=top_k or None)
        if mode == "train":
            generator = torch.Generator(device=self.device).manual_seed(
                int(cfg.SYSTEM.get("SEED", 42)))
            self._train_step = make_train_step(
                self.model, SetCriterion(build_criterion_config(cfg)),
                self.optimizer, self.scheduler, self.max_instances, generator)
            self.monitor = build_monitor(cfg)
            self.monitor.load_info(cfg)
            save_all_cfg(cfg, self.output_dir)
            self._train_data = build_dataloader(cfg, "train")
            self.train_loader = iter(self._train_data)
        self.total_iters = cfg.SOLVER.ITERATION_TOTAL
        self.best_val = float("-inf")

    def train(self) -> float:
        """Run iterations ``start_iter .. ITERATION_TOTAL - 1``; returns the
        wall time in seconds."""
        cfg = self.cfg
        t0 = time.perf_counter()
        val_every = int(cfg.SOLVER.get("ITERATION_VAL", 0) or 0)
        for it in range(self.start_iter, self.total_iters):
            metrics = self._train_step(next(self.train_loader))
            lr = self.solver.base_lr * warmup_poly_factor(it, self.solver)
            self.monitor.update(it, metrics, lr, total_iters=self.total_iters)
            if val_every and (it + 1) % val_every == 0:
                self.validate(it + 1)
            if (it + 1) % cfg.SOLVER.ITERATION_SAVE == 0 and \
                    (it + 1) >= cfg.SOLVER.START_SAVE:
                self.save_checkpoint(it)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.train_loader.close()          # stops the producer thread
        self._train_data.close()           # and the item workers
        self.monitor.close()
        return time.perf_counter() - t0

    def validate(self, iteration: int) -> Dict[str, float]:
        """Score the val split, log it, and keep ``checkpoint_best`` at the
        best SBD."""
        if not hasattr(self, "_val_loader"):
            self._val_loader = build_dataloader(self.cfg, "val")
        res = self.eval_cvppp(loader=iter(self._val_loader),
                              model_name=f"val_{iteration:06d}")
        if hasattr(self, "monitor"):
            self.monitor.add_eval(iteration, res)
        if res["SBD"] > self.best_val:
            self.best_val = res["SBD"]
            ckpt.save_checkpoint(self.output_dir, self.model, self.optimizer,
                                 self.scheduler, iteration, is_best=True)
        return res

    def save_checkpoint(self, iteration: int, is_best: bool = False) -> str:
        return ckpt.save_checkpoint(self.output_dir, self.model, self.optimizer,
                                    self.scheduler, iteration + 1, is_best)

    def predict_labels(self, images):
        """images [B, H, W, 3] -> instance label maps [B, H, W]."""
        return self.evaluator.predict_labels(images)

    def eval_cvppp(self, loader=None, model_name: str = "model") -> Dict[str, float]:
        if loader is None:
            val = build_dataloader(self.cfg, "val")
            res = self.evaluator.eval_cvppp(val)
            val.close()
        else:
            res = self.evaluator.eval_cvppp(loader)
        self._append_log(model_name, [res["SBD"], res["absDiffFG"]])
        return res

    def test_cvppp(self, loader=None, submission: Optional[str] = None) -> str:
        raise NotImplementedError("test_cvppp (the CVPPP test set and its "
                                  "submission.h5): ROADMAP item 19")

    def test_bbbc(self, loader=None, model_name: str = "model") -> Dict[str, float]:
        raise NotImplementedError("test_bbbc (the BBBC eval protocol): ROADMAP item 21")

    def _append_log(self, model_name: str, values) -> None:
        out = self.cfg.INFERENCE.OUTPUT_PATH
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "logging.txt"), "a") as f:
            f.write(model_name + "\n")
            f.write(" ".join(str(v) for v in values) + "\n")
