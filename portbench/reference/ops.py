"""The kernels' plain PyTorch forms (copies of the port's twins at the
time the benchmark was written): multi-scale deformable sampling, the
dynamic mask render, bilinear and nearest resizes, the fused resize and
binarize, and the host LAP matcher."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment


def ms_deform_attn_twin(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a 4-corner gather with hat weights per level,
    in f32.  Differentiable; its autograd is K2's plain version."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    with torch.autocast(value.device.type, enabled=False):
        v32 = value.float()
        loc = sampling_locations.float()
        out = v32.new_zeros((B, M, Lq * P, D))
        start = 0
        for lid, (H, W) in enumerate(spatial_shapes):
            v = v32[:, start:start + H * W].permute(0, 2, 1, 3)   # [B, M, HW, D]
            # [B, Lq, M, P] -> [B, M, Lq*P]
            x = (loc[:, :, :, lid, :, 0] * W - 0.5).permute(0, 2, 1, 3).reshape(B, M, -1)
            y = (loc[:, :, :, lid, :, 1] * H - 0.5).permute(0, 2, 1, 3).reshape(B, M, -1)
            w = attention_weights[:, :, :, lid].float().permute(0, 2, 1, 3).reshape(B, M, -1)
            x0, y0 = torch.floor(x).detach(), torch.floor(y).detach()
            for dy in (0, 1):
                cy = y0 + dy
                hy = torch.relu(1.0 - torch.abs(cy - y))
                for dx in (0, 1):
                    cx = x0 + dx
                    hx = torch.relu(1.0 - torch.abs(cx - x))
                    inside = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)  # NaN: False
                    idx = (cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1))
                    idx = torch.where(inside, idx, 0).long()
                    corner = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, D))
                    cw = torch.where(inside, hx * hy * w, 0.0)
                    out = out + cw[..., None] * corner
            start += H * W
    out = out.reshape(B, M, Lq, P, D).sum(3)                      # [B, M, Lq, D]
    return out.permute(0, 2, 1, 3).reshape(B, Lq, M * D).to(value.dtype)


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights,
                   impl: Optional[str] = None):
    return ms_deform_attn_twin(value, spatial_shapes, sampling_locations,
                               attention_weights)


def render_twin(feats, inst_xy, w1, w2, w3, b1, b2, b3,
                hw: Tuple[int, int], stride: int,
                rel_coord: bool = True,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: ``render_reference`` (``render_pallas.py:60-93``)
    with its casts.  The rel-coord term runs in f32; the feature product,
    stage 1's sum (rel + features + b1), stages 2 and 3 and their biases in
    ``dtype``; the result is f32.  The default f32 is K3's arithmetic; the
    train graph passes the compute dtype, as the JAX train graph does
    (``transformer_decoder.py:436-443``)."""
    Hm, Wm = hw
    with torch.autocast(feats.device.type, enabled=False):
        x = torch.einsum("bso,bqco->bqcs", feats.to(dtype),
                         (w1[..., 2:] if rel_coord else w1).to(dtype))
        if rel_coord:
            dev = feats.device
            xs = torch.arange(Wm, dtype=torch.float32, device=dev) * stride + stride // 2
            ys = torch.arange(Hm, dtype=torch.float32, device=dev) * stride + stride // 2
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            locations = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
            rel = inst_xy.float()[:, :, None, :] - locations[None, None]  # [B,Q,HW,2]
            x = torch.einsum("bqso,bqco->bqcs", rel, w1[..., :2].float()) + x
        # JAX's promotion: an f32 term or bias keeps the sum in f32 until
        # the cast; bf16 + bf16 rounds to bf16 on the add
        x = torch.relu((x + b1[..., None]).to(dtype))
        x = torch.relu(torch.einsum("bqos,bqco->bqcs", x, w2.to(dtype))
                       + b2[..., None].to(dtype))
        x = (torch.einsum("bqos,bqco->bqcs", x, w3.to(dtype))
             + b3[..., None].to(dtype))
    return x[:, :, 0, :].float()


def dynamic_mask_render(*args, impl: Optional[str] = None):
    """Eval's render, in f32 as the port's K3 computes it."""
    return render_twin(*args, dtype=torch.float32)


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


def resize_binarize_twin(x: torch.Tensor, size: Tuple[int, int],
                         logit_t: float) -> torch.Tensor:
    """f32 resize, then compare."""
    return (resize_bilinear(x.float(), size) > logit_t).to(torch.uint8)


def match_padded(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """cost [N, Q, G] (query x ground-truth slot), valid [N, G] bool.

    Returns ``query4gt`` int64 [N, G] on the cost's device: the matched
    query of every valid slot.  Invalid slots get query 0; every consumer
    masks them by ``valid``.
    """
    N, Q, G = cost.shape
    if Q < G:
        raise ValueError(f"match_padded: {Q} queries for {G} slots")
    cost_h = cost.detach().float().cpu().numpy()
    valid_h = valid.cpu().numpy()
    out = np.zeros((N, G), np.int64)
    for n in range(N):
        cols = np.flatnonzero(valid_h[n])
        if cols.size:
            # rows = slots, so every valid slot gets a query
            _, q = linear_sum_assignment(cost_h[n][:, cols].T)
            out[n, cols] = q
    return torch.from_numpy(out).to(cost.device)
