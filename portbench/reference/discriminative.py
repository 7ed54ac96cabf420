"""Discriminative (push-pull) embedding loss (mirror of
``pctrans_tpu/losses/discriminative.py``): pull pixel embeddings toward
their instance centroid, push centroids apart, regularise centroid norms.
The instance map is the label map nearest-downsampled (floor rule) to the
embedding grid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import resize_nearest_torch


def _safe_norm(sq: torch.Tensor) -> torch.Tensor:
    # eps-guarded, not torch.linalg.norm: the norm's gradient at 0 is NaN
    # (a single-pixel instance has e == mu exactly), which poisons every
    # gradient (discriminative.py:47-51, 65-68)
    return torch.sqrt(sq.clamp(min=1e-12))


def discriminative_loss(emb: torch.Tensor, seg: torch.Tensor,
                        max_instances: int, delta_v: float = 0.5,
                        delta_d: float = 3.0, alpha: float = 1.0,
                        beta: float = 1.0, gamma: float = 0.001) -> torch.Tensor:
    """emb [B, h, w, C]; seg [B, H, W] int instance ids (0 = background)."""
    B, h, w, C = emb.shape
    G = max_instances
    s = resize_nearest_torch(seg, (h, w)).reshape(B, h * w).long()
    e = emb.reshape(B, h * w, C)
    ids = torch.arange(1, G + 1, device=seg.device)
    onehot = (s[:, None, :] == ids[None, :, None]).to(e.dtype)     # [B, G, hw]
    cnt = onehot.sum(-1)
    present = cnt > 0
    num_id = present.sum(-1).to(e.dtype)                            # [B]
    safe_cnt = cnt.clamp(min=1.0)
    mu = (onehot @ e) / safe_cnt[..., None]                         # [B, G, C]

    mu_pix = torch.gather(mu, 1, (s - 1).clamp(0, G - 1)[..., None].expand(-1, -1, C))
    d = _safe_norm(((e - mu_pix) ** 2).sum(-1))                     # [B, hw]
    per_inst = (onehot @ ((d - delta_v) ** 2)[..., None])[..., 0] / safe_cnt
    var_loss = torch.where(num_id > 0, (per_inst * present).sum(-1)
                           / num_id.clamp(min=1.0), 0.0)

    diff = mu[:, :, None, :] - mu[:, None, :, :]
    dist = _safe_norm((diff ** 2).sum(-1))
    dist = dist + torch.eye(G, dtype=e.dtype, device=e.device) * delta_d
    pair_ok = present[:, :, None] & present[:, None, :]
    hinge = torch.where(pair_ok, F.relu(delta_d - dist) ** 2, 0.0)
    denom = num_id * (num_id - 1.0)
    dist_loss = torch.where(num_id > 1, hinge.sum((1, 2))
                            / denom.clamp(min=1.0) / 2.0, 0.0)

    norms = _safe_norm((mu ** 2).sum(-1)) * present
    reg_loss = torch.where(num_id > 0, norms.sum(-1) / num_id.clamp(min=1.0), 0.0)
    return alpha * var_loss.mean() + beta * dist_loss.mean() + gamma * reg_loss.mean()
