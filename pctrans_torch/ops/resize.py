"""Resizes with the JAX package's semantics (mirror of
``pctrans_tpu/ops/resize.py``).

Without antialiasing, ``jax.image.resize`` samples at half-pixel centres
with the width-1 triangle kernel and renormalises the taps that fall off
the edge, which is ``F.interpolate(mode="bilinear", align_corners=False)``
in both directions (the FPN upsample and the attention-mask downsample).
``resize_nearest_torch`` is torch's legacy 'nearest' index rule
(``src = floor(dst * in / out)``), which the criterion uses on label maps.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the trailing two axes."""
    h, w = x.shape[-2:]
    y = F.interpolate(x.reshape(1, -1, h, w), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.reshape(*x.shape[:-2], *size)


def resize_nearest_torch(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the trailing two axes with the floor index rule
    (``resize.py:24-36``); an integer downsample ratio is a strided slice."""
    H, W = x.shape[-2:]
    out_h, out_w = size
    if H % out_h == 0 and W % out_w == 0:
        return x[..., ::H // out_h, ::W // out_w]
    rows, cols = nearest_index(H, out_h, x.device), nearest_index(W, out_w, x.device)
    return x[..., rows[:, None], cols[None, :]]


@functools.lru_cache(maxsize=None)
def nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``floor(arange(n_out) * n_in / n_out)`` in f32 on ``device``, built
    once per (sizes, device) and shared, so read-only: built on every call
    it would be a host-to-device copy.  Made outside inference mode, so
    that a train step may save it for backward."""
    with torch.inference_mode(False):
        idx = torch.floor(torch.arange(n_out, dtype=torch.float32) * (n_in / n_out)).long()
        return idx.to(device)
