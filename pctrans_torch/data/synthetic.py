"""Synthetic CVPPP-shaped scenes (numpy), for smoke runs without data.

The same generator as ``pctrans_tpu/data/synthetic.py::make_blob_image``:
coloured elliptical "leaves" on a dark background with consecutive-id
instance labels.  A test holds the two bit-equal for the same seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
