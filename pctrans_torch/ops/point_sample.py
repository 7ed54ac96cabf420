"""Point-sampling helpers of the dense criterion (mirror of
``pctrans_tpu/ops/point_sample.py:204-223, 308-384``).

Coordinates follow ``grid_sample(align_corners=False)``: pixel position
``coord * size - 0.5``, corners outside the map contribute zero.  The
other point modes' samplers come with ROADMAP item 25.
"""

from __future__ import annotations

from typing import Tuple

import torch


def kth_largest_threshold(x: torch.Tensor, k: int, iters: int = 14) -> torch.Tensor:
    """Sort-free approximate k-th largest value along the last axis: the
    same 14-step bisection as the JAX package (``:204-223``), so the
    selected sets ``x >= t`` match.  x [..., P] -> t [..., 1]."""
    lo = x.amin(-1, keepdim=True)
    hi = x.amax(-1, keepdim=True)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        enough = (x >= mid).sum(-1, keepdim=True) >= k
        lo = torch.where(enough, mid, lo)
        hi = torch.where(enough, hi, mid)
    return lo


def _label_onehot_at(seg: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     num_ids: int) -> torch.Tensor:
    """Bilinear samples of every id's one-hot mask at pixel positions
    ``x``/``y`` [B, P] through the label map's four corner labels."""
    B, H, W = seg.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0).float(), (y - y0).float()
    x0i, y0i = x0.long(), y0.long()
    flat = seg.reshape(B, H * W)
    ids = torch.arange(1, num_ids + 1, dtype=seg.dtype, device=seg.device)

    def corner(xi, yi, w):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(flat, 1, idx)                          # [B, P]
        onehot = vals[:, None, :] == ids[None, :, None]            # [B, G, P]
        return onehot.float() * (w * inside)[:, None, :]

    return (corner(x0i, y0i, (1 - tx) * (1 - ty))
            + corner(x0i + 1, y0i, tx * (1 - ty))
            + corner(x0i, y0i + 1, (1 - tx) * ty)
            + corner(x0i + 1, y0i + 1, tx * ty))


def sample_label_onehot_grid(seg: torch.Tensor, hw: Tuple[int, int],
                             num_ids: int) -> torch.Tensor:
    """All ids' one-hot masks bilinearly sampled at the pixel centres of an
    (h, w) grid (``:335-384``).  seg [B, H, W] int -> [B, num_ids, h, w] f32.

    An integer size ratio puts every sample at the same offset inside its
    cell, so the four corners are strided slices of the label map with
    constant weights; other ratios gather the corners.
    """
    B, H, W = seg.shape
    h, w = hw
    ids = torch.arange(1, num_ids + 1, dtype=seg.dtype, device=seg.device)
    if H % h == 0 and W % w == 0:
        ry, rx = H // h, W // w
        oy, ox = (ry - 1) // 2, (rx - 1) // 2
        ty, tx = ((ry - 1) % 2) * 0.5, ((rx - 1) % 2) * 0.5
        out = 0.0
        for dy, dx, wgt in ((0, 0, (1 - ty) * (1 - tx)), (0, 1, (1 - ty) * tx),
                            (1, 0, ty * (1 - tx)), (1, 1, ty * tx)):
            if wgt == 0.0:
                continue
            c = seg[:, oy + dy::ry, ox + dx::rx][:, :h, :w]        # [B, h, w]
            out = out + (c[:, None] == ids[None, :, None, None]).float() * wgt
        return out
    dev = seg.device
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (W / w) - 0.5
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (H / h) - 0.5
    gx = x[None, :].expand(h, w).reshape(1, -1).expand(B, -1)
    gy = y[:, None].expand(h, w).reshape(1, -1).expand(B, -1)
    return _label_onehot_at(seg, gx, gy, num_ids).reshape(B, num_ids, h, w)
