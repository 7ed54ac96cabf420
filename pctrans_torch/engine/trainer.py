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
* ``test_cvppp()``: the CVPPP test split through the label pipeline,
  masked by its foreground, cleaned by ``merge_func``, as u8 maps
  ``A1/<plant>/label`` in ``submission.h5`` (``:501-533``; ``h5py`` is
  imported by the writer only).
* Resume (``:103-113``): a checkpoint restores strictly, else by matching
  keys and shapes; the loop starts at the restored iteration unless
  SOLVER.ITERATION_RESTART (then at MODEL.PRE_MODEL_ITER).
* Multi-card training (``parallel.mesh``, one process per card under
  ``torchrun``): every rank trains on its share of the global batch with the
  global batch's semantics (``train_step``); rank 0 alone writes the
  checkpoints, the SWA file, ``config.yaml``, the monitor's records and
  ``logging.txt``, profiles, and validates, while the others wait at a
  barrier.  The SWA BatchNorm refresh runs on every rank (SyncBN's
  statistics are collective).
* MONITOR.PROFILE_ITERS opens a ``torch.profiler`` window (``utils/monitor``),
  in which the port's spans are on (``utils/tracing``): each iteration is
  span ``train.iteration`` keyed by the iteration (a record without a
  profiler range), with children
  ``train.loader`` (``next()`` and the transfer), ``train.step``
  (``engine/train_step``), ``train.monitor``, and ``train.swa``,
  ``train.validate`` and ``train.checkpoint`` when they run;
  each validation logs one batch's panels (``utils/visualizer``), and a
  failure there is printed and does not stop training.
* INFERENCE.AUG_MODE builds the ``TestAugmentor`` in test mode for naming
  only, as JAX does (``:165-169``); the instance chain does not use it.

The JAX trainer's f16 image and int16 label transfer casts are workarounds
for a slow host-to-TPU link and are not carried.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import CfgNode, build_model_config, save_all_cfg
from ..data.build import build_dataloader
from ..data.cvppp import TEST_PLANTS
from ..losses.criterion import SetCriterion, build_criterion_config
from ..models import PCTransModel
from ..models.resnet import convert_d2_r50_pickle
from ..parallel import mesh
from ..utils import tracing
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
        if cfg.DATASET.DATA_TYPE in ("volume", "tile"):
            raise NotImplementedError(
                f"Trainer: DATASET.DATA_TYPE {cfg.DATASET.DATA_TYPE!r} feeds the legacy "
                "models, whose trainer is not ported yet (ROADMAP slice 6d, item 26c)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self.is_main = self.rank == 0
        n_dev = int(cfg.SYSTEM.NUM_DEVICES)
        if n_dev > 0 and n_dev != self.world:
            raise ValueError(
                f"SYSTEM.NUM_DEVICES {n_dev} with {self.world} process(es): train on N "
                f"cards with one process each, torchrun --nproc_per_node={n_dev} "
                "scripts/main_torch.py --distributed ...")
        self.model_config = build_model_config(cfg)
        self.max_instances = cfg.MODEL.MAX_INSTANCES
        self.output_dir = cfg.DATASET.OUTPUT_PATH
        self.model = PCTransModel(self.model_config,
                                  generator=torch.Generator().manual_seed(0))
        if cfg.MODEL.WEIGHTS and os.path.exists(cfg.MODEL.WEIGHTS):
            if self.model_config.backbone_name != "build_resnet_backbone":
                raise ValueError(f"MODEL.WEIGHTS with {self.model_config.backbone_name}: "
                                 "the weights reader is the detectron2 R-50 pickle's")
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
        self.monitor = None
        if mode == "train":
            # one seed on every rank: the draws are the global batch's
            generator = torch.Generator(device=self.device).manual_seed(
                int(cfg.SYSTEM.get("SEED", 42)))
            self._train_step = make_train_step(
                self.model, SetCriterion(build_criterion_config(cfg)),
                self.optimizer, self.scheduler, self.max_instances, generator,
                solver=self.solver, input_range=self.uint8_range)
            if self.is_main:
                self.monitor = build_monitor(cfg)
                self.monitor.load_info(cfg)
                save_all_cfg(cfg, self.output_dir)
            self._train_data = build_dataloader(cfg, "train", process_index=self.rank,
                                                process_count=self.world)
            self.train_loader = iter(self._train_data)
        self.total_iters = cfg.SOLVER.ITERATION_TOTAL
        self.best_val = float("-inf")
        self.swa = SWAState() if mode == "train" and cfg.SOLVER.SWA.ENABLED else None
        self.tta = None
        if mode == "test" and cfg.INFERENCE.AUG_MODE not in (None, "None", ""):
            from ..data.tta import TestAugmentor

            self.tta = TestAugmentor.build_from_cfg(cfg)

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
        for it in range(self.start_iter, self.total_iters):
            if self.monitor is not None:
                # before the iteration's span: a profiler window opened
                # here traces the whole iteration
                self.monitor.profile_steps(it)
            # a record without a profiler range: a caller's wrapper of the
            # step may open or close a profiler window inside it
            with tracing.span("train.iteration", key=it, ranged=False):
                self._iteration(it, val_every)
        if self.swa is not None and self.swa.params is not None:
            self.save_swa_checkpoint(self.total_iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.train_loader.close()          # stops the producer thread
        self._train_data.close()           # and the item workers
        if self.monitor is not None:
            self.monitor.close()
        return time.perf_counter() - t0

    def _iteration(self, it: int, val_every: int) -> None:
        """The loop body: the batch, the step, the monitor, SWA,
        validation and checkpoints."""
        cfg, swa = self.cfg, self.cfg.SOLVER.SWA
        with tracing.span("train.loader"):
            batch = self.transfer_batch(next(self.train_loader))
        metrics = self._train_step(batch)
        if self.monitor is not None:
            with tracing.span("train.monitor"):
                lr = self.solver.base_lr * lr_factor(it, self.solver)
                self.monitor.update(it, metrics, lr, total_iters=self.total_iters)
        if self.swa is not None:
            with tracing.span("train.swa"):
                self.swa = maybe_update_swa(self.swa, dict(self.model.named_parameters()),
                                            it + 1, swa.START_ITER, swa.MERGE_ITER)
        if val_every and (it + 1) % val_every == 0:
            with tracing.span("train.validate"):
                if self.is_main:
                    self.validate(it + 1)
                mesh.barrier()
        if (it + 1) % cfg.SOLVER.ITERATION_SAVE == 0 and \
                (it + 1) >= cfg.SOLVER.START_SAVE:
            with tracing.span("train.checkpoint"):
                if self.is_main:
                    self.save_checkpoint(it)
                mesh.barrier()
                # checkpoint_swa at each save point too: the averaged
                # weights live in memory only between merges
                if self.swa is not None and self.swa.params is not None:
                    self.save_swa_checkpoint(it + 1)

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
        if self.monitor is not None:
            self.monitor.add_eval(iteration, res)
            self._visualize_val(iteration)
        if primary > self.best_val:
            self.best_val = primary
            ckpt.save_checkpoint(self.output_dir, self.model, self.optimizer,
                                 self.scheduler, iteration, is_best=True)
        return res

    def _visualize_val(self, iteration: int) -> None:
        """One validation batch's (image, ground truth, prediction) panels
        (``pctrans_tpu/engine/trainer.py:306-322``).  A failure here is
        printed and training goes on: the panels are not on the measured
        path."""
        from ..utils.visualizer import Visualizer

        try:
            batch = next(iter(self._val_loader))
            labels = self.predict_labels(batch["image"])
            n = min(2, int(batch.get("_num_valid", labels.shape[0])))
            Visualizer(self.output_dir, tb_writer=self.monitor.tb).visualize(
                iteration, batch["image"][:n],
                batch["label"][:n] if "label" in batch else None,
                labels[:n].astype(np.int32))
        except Exception as e:           # noqa: BLE001 - must not stop training
            print(f"[visualizer] skipped: {type(e).__name__}: {e}")

    def save_checkpoint(self, iteration: int, is_best: bool = False) -> str:
        return ckpt.save_checkpoint(self.output_dir, self.model, self.optimizer,
                                    self.scheduler, iteration + 1, is_best)

    def save_swa_checkpoint(self, iteration: int) -> str:
        """``checkpoint_swa.pth.tar``: the averaged parameters, with the
        BatchNorm statistics refreshed under them over SWA.BN_UPDATE_ITER
        train batches (which the training stream then skips, as in the JAX
        trainer).  The live model gets its weights and statistics back.
        Every rank refreshes (SyncBN is collective); rank 0 writes."""
        live = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(self.swa.params[name])
        try:
            if has_batch_norm(self.model):
                refresh_batch_stats(self.model, self.train_loader,
                                    self.cfg.SOLVER.SWA.BN_UPDATE_ITER)
            if self.is_main:
                return ckpt.save_checkpoint(self.output_dir, self.model, self.optimizer,
                                            self.scheduler, iteration, name="checkpoint_swa")
            return ""
        finally:
            self.model.load_state_dict(live)
            mesh.barrier()

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

    def cvppp_submission(self, loader=None) -> Iterator[Tuple[str, np.ndarray]]:
        """(plant, u8 label map) for each plant of the CVPPP test split (or
        ``loader``'s batches {"image", "fg"}), computed on the device; the
        k-th prediction is named TEST_PLANTS[k], as the JAX writer names it."""
        names = itertools.chain(TEST_PLANTS, (f"plant{k:03d}" for k in
                                              itertools.count(len(TEST_PLANTS))))
        if loader is not None:
            yield from self.evaluator.cvppp_submission(loader, names)
            return
        built = build_dataloader(self.cfg, "test")
        try:
            yield from self.evaluator.cvppp_submission(built, names)
        finally:
            built.close()

    def test_cvppp(self, loader=None, submission: Optional[str] = None) -> str:
        """The CVPPP test split to ``submission.h5`` (in INFERENCE.OUTPUT_PATH
        unless ``submission`` names the file); returns its path."""
        path = submission or os.path.join(self.cfg.INFERENCE.OUTPUT_PATH, "submission.h5")
        n = write_submission(path, self.cvppp_submission(loader))
        print(f"test_cvppp: wrote {n} predictions to {path}")
        return path

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


def write_submission(path: str, predictions) -> int:
    """``A1/<plant>/label`` u8 datasets of (plant, label map) pairs in a new
    h5 file at ``path``; returns how many were written."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("writing submission.h5 needs the h5py package") from e
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = 0
    with h5py.File(path, "w") as f:
        grp = f.create_group("A1")
        for plant, seg in predictions:
            grp.create_group(plant).create_dataset("label", data=seg)
            n += 1
    return n
