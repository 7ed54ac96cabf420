"""Dataset dispatch and the background-prefetching batch loader (mirror of
``pctrans_tpu/data/build.py``).

``build_dataloader(cfg, mode)`` picks the dataset by ``DATASET.DATA_TYPE``
and the batch size by mode (train: SOLVER.SAMPLES_PER_BATCH; CVPPP val: 10;
otherwise INFERENCE.SAMPLES_PER_BATCH).  Items decode in a thread pool; every
item gets its own ``np.random.RandomState`` seeded by (seed, epoch, index),
so batches are the JAX loader's, bit for bit, whatever the thread
scheduling.  Eval loaders pad a ragged last batch by repeating its last item
and carry ``_num_valid``; consumers score only the first ``_num_valid`` rows.

``DATA_TYPE`` ``volume`` / ``tile`` give the legacy EM datasets
(:func:`build_volume_dataset`), which the legacy models train on; their
trainer is not ported yet (ROADMAP slice 6d).

Multi-card training (one process per card): each process takes a
disjoint stride of every epoch's permutation (``process_index`` of
``process_count``) and a batch of SOLVER.SAMPLES_PER_BATCH, its rows of the
global batch, as the JAX loader's processes do.
"""

from __future__ import annotations

import inspect
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from .bbbc import BBBC
from .cvppp import CVPPP
from .instance_folder import CellposeDataset, MoNuSegDataset
from .synthetic import SyntheticDataset, nuclei_scene_rule

def get_dataset(cfg, mode: str):
    dt = cfg.DATASET.DATA_TYPE
    if dt == "CVPPP":
        return CVPPP(cfg.DATASET.INPUT_PATH, mode, crop_size=cfg.MODEL.INPUT_SIZE[-1])
    if dt == "BBBC":
        # the reference crops at 512x512 (dataset_BBBC.py:113), the value
        # the recipe's MODEL.INPUT_SIZE carries
        return BBBC(cfg.DATASET.INPUT_PATH,
                    {"train": "train", "val": "validation", "test": "test"}[mode],
                    crop_size=tuple(cfg.MODEL.INPUT_SIZE[-2:]))
    if dt in ("synthetic", "synthetic_bbbc"):
        size = tuple(cfg.MODEL.INPUT_SIZE[-2:])
        n_inst, radius = (nuclei_scene_rule(size) if dt == "synthetic_bbbc"
                          else ((4, 12), None))
        return SyntheticDataset(size=size, length=64 if mode == "train" else 8,
                                n_instances=n_inst, radius_px=radius,
                                seed={"train": 0, "val": 1, "test": 2}[mode])
    if dt in ("cellpose", "monuseg"):
        cls = CellposeDataset if dt == "cellpose" else MoNuSegDataset
        return cls(cfg.DATASET.INPUT_PATH, mode, crop_size=cfg.MODEL.INPUT_SIZE[-1])
    if dt in ("volume", "tile"):
        return build_volume_dataset(cfg, mode)
    raise ValueError(f"Unknown DATASET.DATA_TYPE: {dt}")


def build_volume_dataset(cfg, mode: str):
    """The legacy EM path (``pctrans_tpu/data/build.py:71-131``): a
    :class:`VolumeDataset` over the volumes IMAGE_NAME / LABEL_NAME /
    VALID_MASK_NAME name, or with DATASET.DO_CHUNK_TITLE 1 a
    :class:`TileDataset` over their JSON tile layouts; the EM augmentor in
    train mode."""
    from .volume_augment import build_train_augmentor
    from .volume_dataset import TileDataset, VolumeDataset, load_volume_inputs

    augmentor = build_train_augmentor(cfg) if mode == "train" else None
    sample_size = list(cfg.MODEL.INPUT_SIZE)
    if len(sample_size) == 2:
        sample_size = [1] + sample_size
    label_size = list(cfg.MODEL.OUTPUT_SIZE or [])
    if len(label_size) == 2:
        label_size = [1] + label_size
    if not label_size or tuple(label_size) == tuple(sample_size):
        label_size = None  # same-size nets: labels match the input crop
    if mode == "train":
        stride = (1, 1, 1)
        iter_num = cfg.SOLVER.ITERATION_TOTAL * cfg.SOLVER.SAMPLES_PER_BATCH
    elif mode == "val":
        stride = [max(1, s // 2) for s in sample_size]
        iter_num = -1
    else:
        stride = cfg.INFERENCE.STRIDE
        iter_num = -1
    rj = cfg.DATASET.REJECT_SAMPLING
    shared = dict(
        mode=mode, sample_volume_size=sample_size, sample_stride=stride,
        sample_label_size=label_size,
        augmentor=augmentor, target_opt=cfg.MODEL.TARGET_OPT,
        weight_opt=cfg.MODEL.WEIGHT_OPT,
        reject_size_thres=rj.SIZE_THRES, reject_diversity=rj.DIVERSITY,
        reject_p=rj.P, data_mean=cfg.DATASET.MEAN, data_std=cfg.DATASET.STD,
        do_relabel=cfg.DATASET.REDUCE_LABEL, do_2d=cfg.DATASET.DO_2D,
        erosion_rates=cfg.MODEL.LABEL_EROSION or None,
        dilation_rates=cfg.MODEL.LABEL_DILATION or None,
    )
    if cfg.DATASET.DO_CHUNK_TITLE == 1:
        root = cfg.DATASET.INPUT_PATH

        def _paths(name):
            if not name:
                return None
            names = name if isinstance(name, (list, tuple)) else [name]
            return [os.path.join(root, n) for n in names]

        return TileDataset(
            volume_json=_paths(cfg.DATASET.IMAGE_NAME),
            label_json=_paths(cfg.DATASET.LABEL_NAME) if mode == "train" else None,
            valid_mask_json=(_paths(cfg.DATASET.VALID_MASK_NAME)
                             if mode == "train" else None),
            chunk_num=cfg.DATASET.DATA_CHUNK_NUM,
            chunk_ind=cfg.DATASET.DATA_CHUNK_IND,
            chunk_ind_split=cfg.DATASET.CHUNK_IND_SPLIT,
            chunk_iter=cfg.DATASET.DATA_CHUNK_ITER,
            chunk_stride=cfg.DATASET.DATA_CHUNK_STRIDE,
            pad_size=cfg.DATASET.PAD_SIZE, **shared)
    img, lab, vm = load_volume_inputs(cfg, mode)
    return VolumeDataset(img, lab, vm, iter_num=iter_num, **shared)


def batch_size_for(cfg, mode: str, n_devices: int = 1) -> int:
    """Global batch size; SOLVER.SAMPLES_PER_BATCH is per device."""
    if mode == "train":
        return cfg.SOLVER.SAMPLES_PER_BATCH * max(n_devices, 1)
    if mode == "val" and cfg.DATASET.DATA_TYPE == "CVPPP":
        return 10
    return cfg.INFERENCE.SAMPLES_PER_BATCH * max(n_devices, 1)


class PrefetchLoader:
    """Iterates batches forever (train) or one epoch (eval), decoding in a
    thread pool ``prefetch`` batches ahead.

    One producer thread assembles batches; only item loads run on the pool,
    so the pool never waits on its own tasks.  Finished batches flow through
    a bounded queue.  A dataset whose ``__getitem__`` takes ``rng`` gets a
    stream per (seed, epoch, index).  With ``process_count`` > 1 each
    process takes the disjoint stride ``process_index::process_count`` of
    every epoch's permutation.
    """

    _SENTINEL = object()

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = True,
                 loop: bool = True, pad_last: bool = False, max_instances: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.process_index = int(process_index)
        self.process_count = max(int(process_count), 1)
        self.loop = loop
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.seed = seed
        self.max_instances = int(max_instances)
        self._truncation_warnings = 0
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.prefetch = max(int(prefetch), 1)
        try:
            self._rng_aware = "rng" in inspect.signature(dataset.__getitem__).parameters
        except (TypeError, ValueError):
            self._rng_aware = False

    def _epoch_indices(self, epoch: int):
        n = len(self.dataset)
        rng = np.random.RandomState((self.seed + 7919 * epoch) % (2**32))
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.process_count > 1:         # this process's disjoint share
            idx = idx[self.process_index::self.process_count]
        n = len(idx)
        bs = self.batch_size
        stop = n - bs + 1 if self.drop_last else n
        if stop <= 0 and (self.drop_last or n == 0):
            raise ValueError(f"dataset yields no batches: {n} item(s) per process for "
                             f"batch_size {bs} (drop_last={self.drop_last})")
        for s in range(0, stop, bs):
            yield idx[s:s + bs]

    def _get_item(self, epoch: int, idx: int):
        if self._rng_aware:
            item_rng = np.random.RandomState(
                (self.seed * 1000003 + epoch * len(self.dataset) + idx) % (2**32))
            return self.dataset.__getitem__(idx, rng=item_rng)
        return self.dataset[idx]

    def _make_batch(self, epoch: int, indices) -> Dict[str, np.ndarray]:
        futures = [self.pool.submit(self._get_item, epoch, int(i)) for i in indices]
        items = [f.result() for f in futures]
        n_valid = len(items)
        if self.pad_last and n_valid < self.batch_size:
            items = items + [items[-1]] * (self.batch_size - n_valid)
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        batch["_num_valid"] = np.int32(n_valid)
        if self.max_instances and "label" in batch:
            # labels are consecutive per image, so max == count
            counts = batch["label"].reshape(len(items), -1).max(axis=1)
            over = counts > self.max_instances
            if over.any():
                self._truncation_warnings += 1
                if self._truncation_warnings <= 5 or self._truncation_warnings % 100 == 0:
                    logging.getLogger(__name__).warning(
                        "instance truncation: %d image(s) in this batch have up "
                        "to %d instances but MODEL.MAX_INSTANCES is %d; the rest "
                        "are dropped from the loss (occurrence %d)",
                        int(over.sum()), int(counts.max()), self.max_instances,
                        self._truncation_warnings)
        return batch

    def close(self) -> None:
        """Release the worker threads (idempotent)."""
        self.pool.shutdown(wait=False)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure: list = [None]

        def produce():
            try:
                epoch = 0
                while not stop.is_set():
                    for indices in self._epoch_indices(epoch):
                        batch = self._make_batch(epoch, indices)
                        while not stop.is_set():
                            try:
                                out.put(batch, timeout=0.2)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                    if not self.loop:
                        return
                    epoch += 1
            except BaseException as e:      # raised again in the consumer
                failure[0] = e
            finally:
                while True:                 # always deliver the sentinel
                    try:
                        out.put(self._SENTINEL, timeout=0.2)
                        return
                    except queue.Full:
                        if stop.is_set():
                            return

        thread = threading.Thread(target=produce, daemon=True, name="prefetch-producer")
        thread.start()
        try:
            while True:
                batch = out.get()
                if batch is self._SENTINEL:
                    if failure[0] is not None:
                        raise RuntimeError("PrefetchLoader producer failed") from failure[0]
                    break
                yield batch
        finally:
            stop.set()
            try:                            # unblock a pending put()
                while True:
                    out.get_nowait()
            except queue.Empty:
                pass


def build_dataloader(cfg, mode: str, seed: int = 0, process_index: int = 0,
                     process_count: int = 1) -> PrefetchLoader:
    """The loader of ``mode``; with ``process_count`` > 1, process
    ``process_index``'s share: a batch of SAMPLES_PER_BATCH (its rows of the
    global batch) over its disjoint stride of each epoch."""
    train = mode == "train"
    global_bs = batch_size_for(cfg, mode, process_count)
    if global_bs % process_count:
        raise ValueError(f"global batch size {global_bs} ({mode}) is not divisible by "
                         f"{process_count} processes; adjust SOLVER/INFERENCE."
                         "SAMPLES_PER_BATCH")
    return PrefetchLoader(
        get_dataset(cfg, mode), batch_size=global_bs // process_count,
        shuffle=train, seed=seed, num_workers=max(2, cfg.SYSTEM.NUM_CPUS // 2),
        loop=train, drop_last=train, pad_last=not train,
        max_instances=int(getattr(cfg.MODEL, "MAX_INSTANCES", 0) or 0),
        process_index=process_index, process_count=process_count)
