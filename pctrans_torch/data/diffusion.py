"""Cellpose diffusion-gradient targets (TARGET_OPT '7'; a copy of
``pctrans_tpu/data/diffusion.py``, which imports no JAX).

Rebuilds ``seg2diffgrads``/``masks2flows``/``extend_centers`` from the
reference (connectomics/data/utils/data_diffusion.py:5-130, itself adapted
from MouseLand/cellpose): heat diffuses from one seed pixel per instance
(the mask pixel closest to the coordinate-median of the mask), restricted to
same-label neighborhoods; the flow target is the normalized spatial gradient
of ``log(1 + heat)``.

Implementation difference from the reference: instead of gathering 9-way
neighbor lists per mask pixel (torch advanced indexing over an [9, Npix]
table), each diffusion step is nine shifted views of the padded heat map
masked by label equality — the same update rule on the full grid, vectorized
in numpy.  The reference's seeding of all-(0,0) center rows for missing
label ids (data_diffusion.py:109 with zero-initialized ``centers``) is
dropped: that seed lands on the padding ring, whose heat can never cross
into any mask (label 0 != mask label), so outputs are identical.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


_SHIFTS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
           (-1, -1), (-1, 1), (1, -1), (1, 1))


def _shift2d(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """View of ``a`` sampled at (y+dy, x+dx), zero outside."""
    h, w = a.shape
    out = np.zeros_like(a)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = a[ys, xs]
    return out


def masks2flows(masks: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """2D instance label map -> (flows [2, h, w], zeros, centers [n, 2]).

    Matches the reference ``masks2flows`` (data_diffusion.py:26-89):
    n_iter = 2 * max over instances of (bbox_h + bbox_w + 2); heat update
    ``T[p] = mean over the 9-neighborhood of same-label heat`` after adding
    1 at each instance seed; flows = central differences of log1p(T),
    L2-normalized per pixel.
    """
    h, w = masks.shape
    mu0 = np.zeros((2, h, w), np.float64)
    mu_c = np.zeros_like(mu0)
    n_max = int(masks.max())
    centers = np.zeros((n_max, 2), "int")
    if n_max == 0:
        return mu0, mu_c, centers

    lab = np.pad(masks, 1).astype(np.int64)
    slices = ndimage.find_objects(masks)

    ext = []
    for i, si in enumerate(slices):
        if si is None:  # label id absent from the map
            continue
        sr, sc = si
        yi, xi = np.nonzero(masks[sr, sc] == (i + 1))
        ymed, xmed = np.median(yi), np.median(xi)
        k = int(np.argmin((xi - xmed) ** 2 + (yi - ymed) ** 2))
        # +1: padded coordinates (reference data_diffusion.py:56-63)
        centers[i, 0] = yi[k] + 1 + sr.start
        centers[i, 1] = xi[k] + 1 + sc.start
        ext.append([sr.stop - sr.start + 1, sc.stop - sc.start + 1])
    if not ext:
        return mu0, mu_c, centers

    n_iter = int(2 * np.asarray(ext).sum(axis=1).max())

    inmask = lab > 0
    seed = np.zeros(lab.shape, np.float64)
    present = [i for i, si in enumerate(slices) if si is not None]
    seed[centers[present, 0], centers[present, 1]] = 1.0
    valid = [(_shift2d(lab, dy, dx) == lab) for dy, dx in _SHIFTS]

    T = np.zeros(lab.shape, np.float64)
    for _ in range(n_iter):
        T += seed
        acc = np.zeros_like(T)
        for (dy, dx), v in zip(_SHIFTS, valid):
            acc += _shift2d(T, dy, dx) * v
        T = np.where(inmask, acc / 9.0, T)

    T = np.log1p(T)
    dy = _shift2d(T, 1, 0) - _shift2d(T, -1, 0)
    dx = _shift2d(T, 0, 1) - _shift2d(T, 0, -1)
    mu = np.stack([dy, dx]) * inmask
    mu /= 1e-20 + np.sqrt((mu ** 2).sum(axis=0))
    mu0 = mu[:, 1:-1, 1:-1]
    return mu0, mu_c, centers


def seg2diffgrads(label: np.ndarray) -> np.ndarray:
    """Instance labels -> flow targets, channel-first.

    (y, x) -> [2, y, x]; (z, y, x) -> [2, z, y, x] computed per-slice
    (reference data_diffusion.py:5-23).  The input rank is preserved (a
    z=1 volume returns [2, 1, y, x], NOT [2, y, x]) so the flow target
    stacks like every other [C, z, y, x] TARGET_OPT output.
    """
    masks = np.asarray(label).astype(np.int32)
    if masks.ndim == 2:
        return masks2flows(masks)[0].astype(np.float32)
    if masks.ndim == 3:
        z = masks.shape[0]
        mu = np.zeros((2,) + masks.shape, np.float32)
        for zi in range(z):
            mu[:, zi] = masks2flows(masks[zi])[0]
        return mu
    raise ValueError(
        "expecting 2D or 3D labels but received %dD input!" % masks.ndim)
