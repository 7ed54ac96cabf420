"""Point sampling of the criterion (mirror of
``pctrans_tpu/ops/point_sample.py``).

Coordinates follow ``grid_sample(align_corners=False)``: pixel position
``coord * size - 0.5``, corners outside the map contribute zero.  Uniform
draws come in as tensors (the JAX package draws them from its keys; the
train step from a ``torch.Generator``), in the shapes JAX draws them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _hats(t: torch.Tensor):
    """The two nonzero bilinear hats of pixel position ``t`` (f32):
    ``relu(1 - |t - s|)`` at s = floor(t) and floor(t) + 1, the JAX hat
    product's own arithmetic, and the two integer corners."""
    t0 = torch.floor(t)
    h0 = (1.0 - (t - t0).abs()).clamp(min=0.0)
    h1 = (1.0 - (t - (t0 + 1.0)).abs()).clamp(min=0.0)
    i0 = t0.long()
    return (i0, h0), (i0 + 1, h1)


def grid_sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                         ) -> torch.Tensor:
    """Sample ``img`` [B, C, H, W] at pixel coordinates (x, y) [B, P];
    returns [B, C, P] in ``img``'s dtype, zero outside the map.

    A 4-corner gather with the JAX hat contraction's roundings
    (``:68-96``): for C <= 8 (its separable body) hat_y is rounded to the
    image dtype and hat_x stays f32, the row sums first; for C > 8 (its
    generator body) the product hat_y * hat_x is rounded to the image dtype;
    the products and sums are f32, and the result is cast back to the image
    dtype.  Every step is elementwise, so a card and a CPU give the same
    bits.  ``F.grid_sample`` on a bf16 map rounds none of the hats and sums
    in bf16."""
    B, C, H, W = img.shape
    P = x.shape[1]
    flat = img.reshape(B, C, H * W)
    (ya, hya), (yb, hyb) = _hats(y.float())
    (xa, hxa), (xb, hxb) = _hats(x.float())

    def corner(xi, yi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))[:, None, :]
        v = torch.gather(flat, 2, idx.expand(B, C, P)).float()
        return v * inside[:, None, :]

    def r(w):                                   # round a weight to img's dtype
        return w.to(img.dtype).float()[:, None, :]

    if C <= 8:
        hya, hyb = r(hya), r(hyb)
        row_a = hya * corner(xa, ya) + hyb * corner(xa, yb)
        row_b = hya * corner(xb, ya) + hyb * corner(xb, yb)
        out = row_a * hxa[:, None, :] + row_b * hxb[:, None, :]
    else:
        out = (r(hya * hxa) * corner(xa, ya) + r(hya * hxb) * corner(xb, ya)
               + r(hyb * hxa) * corner(xa, yb) + r(hyb * hxb) * corner(xb, yb))
    return out.to(img.dtype)


def point_sample(inputs: torch.Tensor, point_coords: torch.Tensor) -> torch.Tensor:
    """PointRend ``point_sample`` (``:126-135``): inputs [B, C, H, W] at
    point_coords [B, P, 2] in [0, 1], ordered (x, y) -> [B, C, P]."""
    H, W = inputs.shape[-2:]
    return grid_sample_bilinear(inputs, point_coords[..., 0] * W - 0.5,
                                point_coords[..., 1] * H - 0.5)


def approx_topk_output_size(n: int, k: int, recall: float = 0.95) -> int:
    """The row length that XLA's ``approx_max_k(..., aggregate_to_topk=False)``
    returns for a rank-2 operand off the TPU (``ApproxTopKReductionOutputSize``):
    the windows its recall target asks for, rounded to 128-wide tiles."""
    tile = 128
    if n <= tile:
        return n
    chunks = -(-n // tile)
    if k == 1:
        log2 = (chunks - 1).bit_length()
    else:
        # XLA evaluates the recall in f32, the logarithm in f64
        m = min(max(int((1.0 - k) / math.log(float(torch.tensor(recall).item()))),
                    tile), n)
        log2 = (n // m).bit_length() - 1
    if log2 == 0:
        return n
    return -(-chunks // (1 << log2)) * tile


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k``'s indices: the k largest along the last axis in
    descending order, ties by the lower index (a stable order).  One
    ``torch.topk`` over an int64 key of the value's order-preserving bits
    and the reversed index, so that no tie is left to the sort."""
    bits = x.float().contiguous().view(torch.int32).long()
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)   # float order
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, device=x.device)
    return torch.topk(ordered * (1 << 32) + rev, k, dim=-1).indices


def get_uncertain_point_coords(logits: torch.Tensor, num_points: int,
                               oversample_ratio: float,
                               importance_sample_ratio: float,
                               candidates: torch.Tensor, fill: torch.Tensor,
                               exact_topk: bool = False) -> torch.Tensor:
    """PointRend importance sampling (``:138-201``): logits [N, 1, H, W];
    ``candidates`` (2, N, num_points * oversample_ratio) and ``fill``
    (N, num_random, 2) uniform draws.  Returns [N, num_points, 2] (x, y).

    ``exact_topk`` keeps the most uncertain candidates as ``jax.lax.top_k``
    does.  Otherwise the JAX package's ``approx_max_k(aggregate_to_topk=
    False)`` path as XLA runs it off the TPU: the row sorted by uncertainty,
    cut to ``approx_topk_output_size`` and strided by its ratio to the count
    kept (at the recipe every 4th of the sorted candidates).  XLA's sort
    orders ties as it meets them; this one by index (ROADMAP.md §C.11)."""
    H, W = logits.shape[-2:]
    cx, cy = candidates[0], candidates[1]
    point_logits = grid_sample_bilinear(logits, cx * W - 0.5, cy * H - 0.5)
    uncert = -point_logits[:, 0, :].abs()
    num_uncertain = int(importance_sample_ratio * num_points)
    if exact_topk:
        idx = _top_indices(uncert, num_uncertain)
    else:
        n = uncert.shape[-1]
        length = approx_topk_output_size(n, num_uncertain)
        idx = _top_indices(uncert, length)
        if length > num_uncertain:
            idx = idx[:, ::max(length // num_uncertain, 1)][:, :num_uncertain]
    picked = torch.stack([torch.gather(cx, 1, idx), torch.gather(cy, 1, idx)], -1)
    if num_points - num_uncertain > 0:
        picked = torch.cat([picked, fill.to(picked.dtype)], dim=1)
    return picked


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


def uncertain_point_weights(logits: torch.Tensor, num_points: int,
                            oversample_ratio: float, importance_sample_ratio: float,
                            candidates: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PointRend importance sampling as per-candidate weights
    (``:226-273``): logits [N, 1, H, W], ``candidates`` (2, N, P) uniform
    draws with P = num_points * oversample_ratio.  The candidates at or
    above the bisection threshold share the selected mass, and every
    candidate carries the fill's share.  Returns (x, y, weights), each
    [N, P]."""
    H, W = logits.shape[-2:]
    P = candidates.shape[-1]
    cx, cy = candidates[0], candidates[1]
    point_logits = grid_sample_bilinear(logits, cx * W - 0.5, cy * H - 0.5)
    uncert = -point_logits[:, 0, :].abs()
    k_imp = int(importance_sample_ratio * num_points)
    sel = uncert >= kth_largest_threshold(uncert, k_imp)
    n_sel = sel.sum(-1, keepdim=True).float()
    w_sel = k_imp / n_sel.clamp(min=1.0)
    w_fill = (num_points - k_imp) / P
    return cx, cy, torch.where(sel, w_sel, 0.0) + w_fill


def sample_label_onehot(seg: torch.Tensor, point_coords: torch.Tensor,
                        num_ids: int) -> torch.Tensor:
    """Every id's one-hot mask bilinearly sampled at point_coords [B, P, 2]
    through the label map's four corner labels (``:282-305``).
    seg [B, H, W] int -> [B, num_ids, P] f32."""
    H, W = seg.shape[1:]
    return _label_onehot_at(seg, point_coords[..., 0] * W - 0.5,
                            point_coords[..., 1] * H - 0.5, num_ids)


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
