"""Cellpose and MoNuSeg instance-segmentation datasets (a copy of
``pctrans_tpu/data/instance_folder.py`` on this package's CVPPP helpers).

* ``CellposeDataset``: ``<root>/{train,test}/`` with ``<stem>_img.png`` +
  ``<stem>_masks.png`` pairs (val reuses the test split);
* ``MoNuSegDataset``: ``<root>/images/<stem>.(png|tif)`` +
  ``<root>/labels/<stem>_ins.npy`` (or ``<stem>_300_ins.npy``, a rescaled
  export: the image is brought to the label's frame), a fixed 80/20
  train/val split of the sorted listing.

Both yield the CVPPP item dict (NHWC float32 image, int label map): train
items through paired random H/V flips, RandomResizedCrop(scale 0.7-1.0) and
ImageNet normalisation; val/test items at full resolution.  PIL and cv2 are
imported at the first read, not at import.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from .cvppp import _resize, normalize_image, random_resized_crop_params
from .label_utils import relabel_consecutive


class _InstanceFolderDataset:
    """Paired flips + RandomResizedCrop on train; the full-resolution
    normalised image and relabelled instances on val/test."""

    def __init__(self, mode: str, crop_size: int = 448, seed: int = 0):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode {mode!r}: one of train, val, test")
        self.mode = mode
        self.crop_size = crop_size
        self._rng = np.random.RandomState(seed)
        self.items = []                     # (image path, label path)

    def __len__(self):
        return len(self.items)

    def _load_pair(self, idx: int):
        raise NotImplementedError

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        rgb, label = self._load_pair(idx)
        if self.mode != "train":
            return {"image": normalize_image(rgb), "label": relabel_consecutive(label)}
        if rng is None:        # the loader passes a per-(epoch, index) stream
            rng = self._rng
        if rng.rand() < 0.5:
            rgb, label = rgb[:, ::-1], label[:, ::-1]
        if rng.rand() < 0.5:
            rgb, label = rgb[::-1], label[::-1]
        H, W = label.shape[:2]
        i, j, h, w = random_resized_crop_params(rng, H, W)
        rgb = _resize(np.ascontiguousarray(rgb[i:i + h, j:j + w]), self.crop_size,
                      nearest=False)
        label = _resize(np.ascontiguousarray(label[i:i + h, j:j + w]), self.crop_size,
                        nearest=True)
        return {"image": normalize_image(rgb), "label": relabel_consecutive(label)}


class CellposeDataset(_InstanceFolderDataset):
    """``<root>/{train,test}/<stem>_img.png`` + ``<stem>_masks.png``."""

    def __init__(self, root: str, mode: str, crop_size: int = 448, seed: int = 0):
        super().__init__(mode, crop_size, seed)
        d = os.path.join(root, "train" if mode == "train" else "test")
        masks = sorted(glob.glob(os.path.join(d, "*_masks.png")))
        self.items = [(m.replace("_masks.png", "_img.png"), m) for m in masks]

    def _load_pair(self, idx: int):
        from PIL import Image

        ip, lp = self.items[idx]
        rgb = np.asarray(Image.open(ip).convert("RGB"))
        label = np.asarray(Image.open(lp)).astype(np.int64)
        return rgb, label


class MoNuSegDataset(_InstanceFolderDataset):
    """``<root>/images/<stem>.*`` + ``<root>/labels/<stem>[_300]_ins.npy``."""

    def __init__(self, root: str, mode: str, crop_size: int = 448, seed: int = 0):
        super().__init__(mode, crop_size, seed)
        lab_dir = os.path.join(root, "labels")
        paths = sorted(p for p in glob.glob(os.path.join(root, "images", "*"))
                       if os.path.isfile(p))
        items = []
        for p in paths:
            stem = os.path.splitext(os.path.basename(p))[0]
            for cand in (f"{stem}_ins.npy", f"{stem}_300_ins.npy"):
                lp = os.path.join(lab_dir, cand)
                if os.path.exists(lp):
                    items.append((p, lp))
                    break
        n_val = max(1, len(items) // 5) if items else 0
        if mode == "train":
            self.items = items[n_val:]
        else:
            self.items = items[:n_val] if mode == "val" else items

    def _load_pair(self, idx: int):
        from PIL import Image

        ip, lp = self.items[idx]
        rgb = np.asarray(Image.open(ip).convert("RGB"))
        label = np.load(lp).astype(np.int64)
        if rgb.shape[:2] != label.shape[:2]:
            # a rescaled label export: crops are taken in the label's frame
            rgb = _resize(rgb, label.shape[:2], nearest=False)
        return rgb, label
