"""BBBC039 nuclei dataset (a copy of ``pctrans_tpu/data/bbbc.py:29-183``).

The reference loader (connectomics/data/dataset/dataset_BBBC.py:47-224):
metadata/{training,validation,test}.txt splits, min-max image
normalisation; train items reflect-pad 30, take a random (crop + 60)^2
window, apply flip / rotation / elastic / grayscale augmentations each with
p = 0.5 inside a 0.8 gate, then reflect-pad 10 and center-crop; validation
items are zero-padded to 704x704; test items are the full 520x696 image.
The single gray channel is replicated to 3.

PIL, cv2 and scipy are imported inside the functions that use them, not at
import: the port runs without them where no BBBC tree is read.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .label_utils import relabel_consecutive


# ------------------------------------------------------------- augmentations
def aug_flip(rng: np.random.RandomState, img: np.ndarray, label: np.ndarray):
    """Random y/x reflection and xy transpose (augmentation_BBBC/flip.py)."""
    rule = rng.randint(2, size=4)
    out = []
    for arr in (img, label):
        if rule[0]:
            arr = arr[::-1, :]
        if rule[1]:
            arr = arr[:, ::-1]
        if rule[2]:
            arr = arr.transpose(1, 0)
        out.append(np.ascontiguousarray(arr))
    return out[0], out[1]


def aug_rotate(rng: np.random.RandomState, img: np.ndarray, label: np.ndarray):
    """Continuous xy rotation (augmentation_BBBC/rotation.py); the centre is
    (w/2, h/2) and dsize (w, h), cv2's order."""
    import cv2

    h, w = img.shape[-2:]
    M = cv2.getRotationMatrix2D((w / 2, h / 2), rng.rand() * 360.0, 1)
    img = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT)
    label = cv2.warpAffine(label.astype(np.float32), M, (w, h),
                           flags=cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT)
    return img, label


def aug_elastic(rng: np.random.RandomState, img: np.ndarray, label: np.ndarray,
                alpha: float = 16.0, sigma: float = 4.0):
    """Elastic deformation (augmentation_BBBC/warp.py, Simard 2003)."""
    import cv2
    from scipy.ndimage import gaussian_filter

    h, w = img.shape[-2:]
    dx = np.float32(gaussian_filter(rng.rand(h, w) * 2 - 1, sigma) * alpha)
    dy = np.float32(gaussian_filter(rng.rand(h, w) * 2 - 1, sigma) * alpha)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    mapx, mapy = np.float32(x + dx), np.float32(y + dy)
    img = cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
    label = cv2.remap(label.astype(np.float32), mapx, mapy, cv2.INTER_NEAREST,
                      borderMode=cv2.BORDER_CONSTANT)
    return img, label


def aug_grayscale(rng: np.random.RandomState, img: np.ndarray,
                  contrast: float = 0.3, brightness: float = 0.3):
    """Contrast and brightness jitter, then gamma
    (augmentation_BBBC/grayscale.py on one slice)."""
    ran = rng.rand(3)
    out = img * (1 + (ran[0] - 0.5) * contrast)
    out = np.clip(out + (ran[1] - 0.5) * brightness, 0, 1)
    return out ** (2.0 ** (ran[2] * 2 - 1))


def center_crop_2d(image: np.ndarray, det_shape=(512, 512)) -> np.ndarray:
    """Reflect-pad 10, then center crop (dataset_BBBC.py:216-224)."""
    image = np.pad(image, ((10, 10), (10, 10)), mode="reflect")
    s0 = (image.shape[0] - det_shape[0]) // 2
    s1 = (image.shape[1] - det_shape[1]) // 2
    return image[s0:s0 + det_shape[0], s1:s1 + det_shape[1]]


def _gray3(img: np.ndarray) -> np.ndarray:
    return np.repeat(img[:, :, None], 3, axis=2).astype(np.float32)


class BBBC:
    """mode 'train' | 'validation' | 'test'; files as in the reference
    (dataset_BBBC.py:82-105): ``<root>/images/*.tif``,
    ``<root>/label_instance/*.png``, ``<root>/metadata/*.txt``."""

    def __init__(self, root: str, mode: str, crop_size=(512, 512), seed: int = 0,
                 padding: int = 30):
        if mode not in ("train", "validation", "test"):
            raise ValueError(f"BBBC mode {mode!r}")
        self.mode = mode
        self.root = root
        self.crop_size = tuple(crop_size)
        self.padding = padding
        meta = {"train": "training.txt", "validation": "validation.txt",
                "test": "test.txt"}[mode]
        with open(os.path.join(root, "metadata", meta)) as f:
            self.ids = [x.strip()[:-4] if x.strip().endswith(".png") else x.strip()
                        for x in f if x.strip()]
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.ids)

    def _load_pair(self, idx: int):
        from PIL import Image

        name = self.ids[idx]
        img = np.asarray(Image.open(os.path.join(self.root, "images", name + ".tif")))
        img = img.astype(np.float32)
        img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
        label = np.asarray(Image.open(
            os.path.join(self.root, "label_instance", name + ".png"))).astype(np.int32)
        return img, label

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        img, label = self._load_pair(idx)
        if self.mode == "test":
            return {"image": _gray3(img), "label": label}
        if self.mode == "validation":
            pad = ((92, 92), (4, 4))
            return {"image": _gray3(np.pad(img, pad, mode="constant")),
                    "label": np.pad(label, pad, mode="constant")}

        if rng is None:        # the loader passes a per-(epoch, index) stream
            rng = self._rng
        pad = self.padding
        img = np.pad(img, ((pad, pad), (pad, pad)), mode="reflect")
        label = np.pad(label, ((pad, pad), (pad, pad)), mode="reflect")
        ch, cw = self.crop_size[0] + 2 * pad, self.crop_size[1] + 2 * pad
        rx = rng.randint(0, img.shape[0] - ch + 1)
        ry = rng.randint(0, img.shape[1] - cw + 1)
        img, label = img[rx:rx + ch, ry:ry + cw], label[rx:rx + ch, ry:ry + cw]

        if rng.rand() < 0.8:
            if rng.rand() > 0.5:
                img, label = aug_flip(rng, img, label)
            if rng.rand() > 0.5:
                img, label = aug_rotate(rng, img, label)
            if rng.rand() > 0.5:
                img, label = aug_elastic(rng, img, label)
            if rng.rand() > 0.5:
                img = aug_grayscale(rng, img)

        img = center_crop_2d(img, self.crop_size)
        label = center_crop_2d(label, self.crop_size)
        return {"image": _gray3(img), "label": relabel_consecutive(label.astype(np.int32))}
