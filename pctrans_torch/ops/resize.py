"""Bilinear resize with ``jax.image.resize(antialias=False)`` semantics
(mirror of ``pctrans_tpu/ops/resize.py:18-21``).

Without antialiasing, ``jax.image.resize`` samples at half-pixel centres
with the width-1 triangle kernel and renormalises the taps that fall off
the edge, which is ``F.interpolate(mode="bilinear", align_corners=False)``
in both directions (the FPN upsample and the attention-mask downsample).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the trailing two axes."""
    h, w = x.shape[-2:]
    y = F.interpolate(x.reshape(1, -1, h, w), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.reshape(*x.shape[:-2], *size)
