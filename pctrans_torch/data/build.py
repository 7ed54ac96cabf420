"""Dataset dispatch and the background-prefetching batch loader (mirror of
``pctrans_tpu/data/build.py``).

``build_dataloader(cfg, mode)`` picks the dataset by ``DATASET.DATA_TYPE``
and the batch size by mode (train: SOLVER.SAMPLES_PER_BATCH; CVPPP val: 10;
otherwise INFERENCE.SAMPLES_PER_BATCH).  Items decode in a thread pool; every
item gets its own ``np.random.RandomState`` seeded by (seed, epoch, index),
so batches are the JAX loader's, bit for bit, whatever the thread
scheduling.  Eval loaders pad a ragged last batch by repeating its last item
and carry ``_num_valid``; consumers score only the first ``_num_valid`` rows.

One process reads the whole batch: the multi-process shard of the JAX
loader comes with multi-card training (ROADMAP slice 4).
"""

from __future__ import annotations

import inspect
import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from .bbbc import BBBC
from .cvppp import CVPPP
from .synthetic import SyntheticDataset, nuclei_scene_rule

_NOT_PORTED = {
    "cellpose": "ROADMAP item 21a (instance-folder datasets)",
    "monuseg": "ROADMAP item 21a (instance-folder datasets)",
    "volume": "ROADMAP item 26 (the legacy EM zoo)",
    "tile": "ROADMAP item 26 (the legacy EM zoo)",
}


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
    if dt in _NOT_PORTED:
        raise NotImplementedError(f"DATASET.DATA_TYPE {dt!r}: not ported yet, "
                                  f"{_NOT_PORTED[dt]}")
    raise ValueError(f"Unknown DATASET.DATA_TYPE: {dt}")


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
    stream per (seed, epoch, index).
    """

    _SENTINEL = object()

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = True,
                 loop: bool = True, pad_last: bool = False, max_instances: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
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
        bs = self.batch_size
        stop = n - bs + 1 if self.drop_last else n
        if stop <= 0 and (self.drop_last or n == 0):
            raise ValueError(f"dataset yields no batches: {n} item(s) for "
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


def build_dataloader(cfg, mode: str, seed: int = 0) -> PrefetchLoader:
    train = mode == "train"
    return PrefetchLoader(
        get_dataset(cfg, mode), batch_size=batch_size_for(cfg, mode),
        shuffle=train, seed=seed, num_workers=max(2, cfg.SYSTEM.NUM_CPUS // 2),
        loop=train, drop_last=train, pad_last=not train,
        max_instances=int(getattr(cfg.MODEL, "MAX_INSTANCES", 0) or 0))
