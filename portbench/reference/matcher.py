"""Hungarian matchers (mirror of ``pctrans_tpu/losses/matcher.py``): CE +
dice costs evaluated at every pixel of the prediction grid (the dense mode)
or at uniform random points shared by an image's masks (the point-sampled
``Point_HungarianMatcher``), one assignment per lane on the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .ops import match_padded
from .point_sample import point_sample, sample_label_onehot


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` step by step in ``x``'s dtype: each op rounds to
    it, as XLA evaluates the bf16 formula."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` step by step in ``x``'s dtype up to the last
    division, which is f32: every consumer reads the result in f32, and
    XLA then drops that last rounding.  For the matcher's costs only: its
    autograd is NaN where ``exp(-x)`` overflows (the losses differentiate
    ``torch.sigmoid``)."""
    return 1.0 / (1.0 + torch.exp(-x)).float()


def pair_costs(out_pts: torch.Tensor, tgt_pts: torch.Tensor,
               cost_mask: float, cost_dice: float) -> torch.Tensor:
    """out_pts [N, Q, P] logits, tgt_pts [N, G, P] in the same dtype (the
    criterion's sample dtype).  Returns the [N, Q, G] f32 cost.

    The elementwise terms run in the inputs' dtype; the products take them
    in f32 and sum in f32, as ``preferred_element_type=f32`` does (a bf16
    ``torch.matmul`` would round its output to bf16)."""
    P = out_pts.shape[-1]
    t = tgt_pts.float().transpose(1, 2)
    pos = softplus(-out_pts).float()               # BCE(out, 1)
    neg = softplus(out_pts).float()                # BCE(out, 0)
    ce = (pos @ t + neg @ (1.0 - tgt_pts).float().transpose(1, 2)) / P
    sig = sigmoid(out_pts)
    numer = 2.0 * (sig @ t)
    denom = sig.sum(-1)[:, :, None] + t.sum(1)[:, None, :]
    dice = 1.0 - (numer + 1.0) / (denom + 1.0)
    return cost_mask * ce + cost_dice * dice


@torch.no_grad()
def dense_matcher_costs(pred_logits: torch.Tensor, tgt_dense: torch.Tensor,
                        valid: torch.Tensor, cost_mask: float = 5.0,
                        cost_dice: float = 5.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """pred_logits [N, Q, h, w] (in the sample dtype), tgt_dense [N, G, h*w]
    GT on the same grid, valid [N, G].  Returns (query4gt int64 [N, G],
    cost [N, Q, G] f32)."""
    N, Q = pred_logits.shape[:2]
    cost = pair_costs(pred_logits.reshape(N, Q, -1),
                      tgt_dense.to(pred_logits.dtype), cost_mask, cost_dice)
    return match_padded(cost, valid), cost



@torch.no_grad()
def point_matcher_costs(pred_logits: torch.Tensor, gt_seg: torch.Tensor,
                        valid: torch.Tensor, coords: torch.Tensor,
                        cost_mask: float = 5.0, cost_dice: float = 5.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``match_one_image`` per lane (``matcher.py:48-71, 102-116``):
    pred_logits [N, Q, h, w] in the sample dtype, gt_seg [N, H, W] int,
    valid [N, G], coords [N, P, 2] uniform draws shared by the lane's masks.
    All Q masks are sampled as channels of one map (Q > 8: the generator
    rounding).  Returns (query4gt int64 [N, G], cost [N, Q, G] f32)."""
    G = valid.shape[1]
    out_pts = point_sample(pred_logits, coords)                    # [N, Q, P]
    tgt_pts = sample_label_onehot(gt_seg, coords, G).to(pred_logits.dtype)
    cost = pair_costs(out_pts, tgt_pts, cost_mask, cost_dice)
    return match_padded(cost, valid), cost
