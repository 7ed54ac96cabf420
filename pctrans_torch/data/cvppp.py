"""CVPPP A1 leaf-segmentation dataset (a copy of
``pctrans_tpu/data/cvppp.py``): ``plantXXX_rgb.png`` / ``_label.png`` /
``_fg.png`` files, the fixed 20-plant validation split, and the training
augmentations (paired random H/V flips, RandomResizedCrop(448, scale=(0.7,
1.0)) with bilinear images and nearest labels, ImageNet normalisation),
labels relabelled to consecutive ids per crop.

Output layout is NHWC float32 images and int32 [H, W] labels.  PIL and cv2
are imported at the first read, not at import: the port runs without them
where no dataset is read (``DATASET.DATA_TYPE synthetic``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .label_utils import relabel_consecutive

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

VAL_PLANTS = [
    "plant002", "plant016", "plant029", "plant037", "plant045", "plant046",
    "plant055", "plant061", "plant072", "plant080", "plant088", "plant099",
    "plant104", "plant108", "plant115", "plant127", "plant130", "plant142",
    "plant148", "plant159",
]

# the 33 plants of the A1 test release, in order: ``test_cvppp`` names its
# k-th prediction TEST_PLANTS[k] in ``submission.h5``
TEST_PLANTS = [
    "plant003", "plant004", "plant009", "plant014", "plant019", "plant023",
    "plant025", "plant028", "plant034", "plant041", "plant056", "plant066",
    "plant074", "plant075", "plant081", "plant087", "plant093", "plant095",
    "plant097", "plant103", "plant111", "plant112", "plant117", "plant122",
    "plant125", "plant131", "plant136", "plant140", "plant150", "plant155",
    "plant157", "plant158", "plant160",
]


def random_resized_crop_params(
    rng: np.random.RandomState,
    height: int,
    width: int,
    scale: Tuple[float, float] = (0.7, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params semantics (10 tries, then
    the largest centre crop within the ratio bounds)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h + 1)
            j = rng.randint(0, width - w + 1)
            return i, j, h, w
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def _resize(img: np.ndarray, size, nearest: bool) -> np.ndarray:
    """size: int (square) or (h, w)."""
    import cv2

    h, w = (size, size) if isinstance(size, int) else size
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.resize(img, (w, h), interpolation=interp)


def normalize_image(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC, ImageNet-normalised."""
    x = img_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


class CVPPP:
    """mode 'train' | 'val' | 'test'; files under ``<root>/{train,val,test}/``.
    The test split has rgb and fg only (its labels are withheld)."""

    def __init__(self, root: str, mode: str, crop_size: int = 448, seed: int = 0):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"CVPPP mode {mode!r}: one of train, val, test")
        self.mode = mode
        self.crop_size = crop_size
        self.dir = os.path.join(root, mode)
        files = sorted(os.listdir(self.dir)) if os.path.isdir(self.dir) else []
        plants = sorted({f[:8] for f in files if f.startswith("plant")})
        if mode == "val":
            plants = [p for p in plants if p in VAL_PLANTS]
            if not plants:
                raise FileNotFoundError(
                    f"CVPPP val split: no plants from the 20-plant val list "
                    f"found in {self.dir}")
        elif mode == "train":
            plants = [p for p in plants if p not in VAL_PLANTS]
        self.plants = plants
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.plants)

    def _load(self, plant: str, kind: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(os.path.join(self.dir, f"{plant}_{kind}.png"))
        if kind == "rgb":
            img = img.convert("RGB")
        return np.asarray(img)

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        plant = self.plants[idx]
        rgb = self._load(plant, "rgb")
        if self.mode == "test":
            fg = relabel_consecutive(self._load(plant, "fg"))
            return {"image": normalize_image(rgb), "fg": fg.astype(np.int32)}
        label = self._load(plant, "label")
        if self.mode == "val":
            fg = self._load(plant, "fg")
            return {"image": normalize_image(rgb),
                    "label": relabel_consecutive(label),
                    "fg": (np.asarray(fg) > 0).astype(np.int32)}

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
        label = _resize(np.ascontiguousarray(label[i:i + h, j:j + w]),
                        self.crop_size, nearest=True)
        return {"image": normalize_image(rgb), "label": relabel_consecutive(label)}
