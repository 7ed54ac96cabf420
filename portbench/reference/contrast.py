"""Query-contrast (re-id) losses with fixed shapes (mirror of
``pctrans_tpu/losses/contrast.py``), batched over images.

For every matched query (one per valid ground-truth slot) its cluster is
the set of unmatched queries whose cosine-similarity argmax over matched
queries lands on it; items with an empty cluster are skipped.  The
contrastive term is ``log(1 + sum_n exp(c_n/T) * sum_p exp(-c_p/T))``; the
auxiliary cosine regression samples ``min(10 |pos|, |neg|)`` negatives
uniformly without replacement by ranking uniform draws that the caller
passes in (``reid_uniform``), so a test can feed the JAX package's draws.
"""

from __future__ import annotations

from typing import Tuple

import torch

_NEG_BIG = -1e30


def _masked_lse(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """logsumexp over the masked entries of the last axis; an empty mask
    gives ~-1e30 (exp -> 0)."""
    z = torch.where(mask, x, _NEG_BIG)
    m = z.amax(-1, keepdim=True).clamp(min=_NEG_BIG)
    s = torch.where(mask, torch.exp(z - m), 0.0).sum(-1)
    return m[..., 0] + torch.log(s.clamp(min=1e-30))


def cosine_similarity_matrix(query: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine similarity of [..., Q, C] embeddings."""
    norms = torch.linalg.vector_norm(query, dim=-1)
    denom = (norms[..., :, None] * norms[..., None, :]).clamp(min=eps)
    return (query @ query.transpose(-1, -2)) / denom


def pairwise_mask_dice(mask_logits: torch.Tensor) -> torch.Tensor:
    """dice[i, j] of sigmoided flattened masks [..., Q, h, w], in f32."""
    s = torch.sigmoid(mask_logits.flatten(-2).float())
    numer = s @ s.transpose(-1, -2)
    sums = s.sum(-1)
    return (2.0 * numer + 1.0) / (sums[..., :, None] + sums[..., None, :] + 1.0)


def _clusters(emb_dist: torch.Tensor, query4gt: torch.Tensor,
              valid: torch.Tensor):
    """emb_dist [B, Q, Q], query4gt/valid [B, G] ->
    (pos_mask [B, G, Q], neg_mask [B, G, Q], active [B, G])."""
    B, Q, _ = emb_dist.shape
    G = query4gt.shape[1]
    qids = torch.arange(Q, device=emb_dist.device)
    key_onehot = qids[None, None, :] == query4gt[:, :, None]          # [B, G, Q]
    matched = (key_onehot & valid[:, :, None]).any(1)                 # [B, Q]
    sim = torch.gather(emb_dist, 2, query4gt[:, None, :].expand(B, Q, G))
    sim = torch.where(valid[:, None, :], sim, _NEG_BIG)               # [B, Q, G]
    nearest = sim.argmax(-1)                                          # [B, Q]
    gids = torch.arange(G, device=emb_dist.device)
    pos_mask = (~matched[:, None, :] & (nearest[:, None, :] == gids[None, :, None])
                & valid[:, :, None])
    neg_mask = ~pos_mask & ~key_onehot & valid[:, :, None]
    active = valid & (pos_mask.sum(-1) > 0)
    return pos_mask, neg_mask, active


def reid_losses(query: torch.Tensor, emb_dist: torch.Tensor,
                mask_dice: torch.Tensor, query4gt: torch.Tensor,
                valid: torch.Tensor, reid_uniform: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``reid_losses_one_image`` (``contrast.py:69-113``) for every image.

    query [B, Q, C] (final decoder output, pre-norm); emb_dist and
    mask_dice [B, Q, Q]; query4gt/valid [B, G]; reid_uniform [B, G, Q]
    uniform [0, 1) draws.  Returns per-image sums [B]:
    (contrast_q, aux_q, contrast_m, n_items).
    """
    pos_mask, neg_mask, active = _clusters(emb_dist, query4gt, valid)
    C = query.shape[-1]
    Q = query.shape[1]
    keys = torch.gather(query, 1, query4gt[..., None].expand(-1, -1, C))  # [B, G, C]
    pred = (keys @ query.transpose(1, 2)) / 2.0                          # [B, G, Q]
    lse = _masked_lse(pred, neg_mask) + _masked_lse(-pred, pos_mask)
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    contrast_q = torch.where(active, torch.logaddexp(zero, lse), 0.0)

    n_pos = pos_mask.sum(-1)
    n_neg = neg_mask.sum(-1)
    n_samp = torch.minimum(10 * n_pos, n_neg)
    score = torch.where(neg_mask, reid_uniform.to(pred.dtype), float("inf"))
    rank = torch.argsort(torch.argsort(score, dim=-1, stable=True), dim=-1,
                         stable=True)
    sel = neg_mask & (rank < n_samp[..., None])
    rows = query4gt[..., None].expand(-1, -1, Q)
    cos = torch.gather(emb_dist, 1, rows)                               # [B, G, Q]
    sq_err = (torch.where(pos_mask, (cos - 1.0) ** 2, 0.0)
              + torch.where(sel, cos ** 2, 0.0))
    denom = (n_pos + n_samp).clamp(min=1)
    aux_q = torch.where(active, sq_err.sum(-1) / denom, 0.0)

    dm = torch.gather(mask_dice, 1, rows) / 0.5
    lse_m = _masked_lse(dm, neg_mask) + _masked_lse(-dm, pos_mask)
    contrast_m = torch.where(active, torch.logaddexp(zero, lse_m), 0.0)
    return contrast_q.sum(-1), aux_q.sum(-1), contrast_m.sum(-1), active.sum(-1)
