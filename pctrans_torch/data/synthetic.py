"""Synthetic CVPPP-shaped scenes (numpy), for runs without data.

The same generator and dataset as ``pctrans_tpu/data/synthetic.py``:
coloured elliptical "leaves" on a dark background with consecutive-id
instance labels, deterministic per (seed, index).  Tests hold the two
bit-equal.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def make_blob_image(
    rng: np.random.RandomState,
    size: Tuple[int, int] = (448, 448),
    n_instances: Tuple[int, int] = (4, 12),
    radius_px: Optional[Tuple[float, float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (image [H, W, 3] float32, label [H, W] int32).

    Blob radii are fractions of the image (few large leaves) unless
    ``radius_px`` gives them in pixels (dense small nuclei).
    """
    H, W = size
    n = rng.randint(n_instances[0], n_instances[1] + 1)
    label = np.zeros((H, W), np.int32)
    img = rng.randn(H, W, 3).astype(np.float32) * 0.05

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    next_id = 1
    for _ in range(n):
        cy = rng.uniform(0.1 * H, 0.9 * H)
        cx = rng.uniform(0.1 * W, 0.9 * W)
        if radius_px is not None:
            ry = rng.uniform(*radius_px)
            rx = rng.uniform(*radius_px)
        else:
            ry = rng.uniform(0.04, 0.12) * H
            rx = rng.uniform(0.04, 0.12) * W
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        u = (xx - cx) * ct + (yy - cy) * st
        v = -(xx - cx) * st + (yy - cy) * ct
        mask = ((u / rx) ** 2 + (v / ry) ** 2 < 1.0) & (label == 0)  # disjoint
        if mask.sum() < 20:
            continue
        label[mask] = next_id
        color = rng.uniform(0.3, 1.0, size=3).astype(np.float32)
        img[mask] = color + rng.randn(int(mask.sum()), 3).astype(np.float32) * 0.05
        next_id += 1

    # relabel consecutively (skipped blobs leave gaps)
    ids = np.unique(label)
    remap = np.zeros(ids.max() + 1, np.int32)
    remap[ids] = np.arange(len(ids))
    return img, remap[label]


class SyntheticDataset:
    """Finite synthetic dataset with deterministic content per index."""

    def __init__(self, size=(448, 448), length: int = 64, seed: int = 0,
                 n_instances=(4, 12), cache: bool = True, radius_px=None):
        self.size = tuple(size)
        self.length = length
        self.seed = seed
        self.n_instances = n_instances
        self.radius_px = radius_px
        # content is fixed per index: memoize instead of regenerating each
        # epoch
        self._cache: Optional[dict] = {} if cache else None

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        rng = np.random.RandomState(self.seed * 100003 + idx)
        img, label = make_blob_image(rng, self.size, self.n_instances,
                                     radius_px=self.radius_px)
        item = {"image": img, "label": label}
        if self._cache is not None:
            self._cache[idx] = item
        return item


def batch_iterator(dataset, batch_size: int, rng: np.random.RandomState,
                   shuffle: bool = True) -> Iterator[dict]:
    """Infinite batch iterator yielding stacked numpy dicts."""
    n = len(dataset)
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - batch_size + 1, batch_size):
            items = [dataset[int(i)] for i in idx[s:s + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
