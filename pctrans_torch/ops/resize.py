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
    rows = torch.floor(torch.arange(out_h, dtype=torch.float32) * (H / out_h)).long()
    cols = torch.floor(torch.arange(out_w, dtype=torch.float32) * (W / out_w)).long()
    return x[..., rows.to(x.device)[:, None], cols.to(x.device)[None, :]]
