"""SetCriterion: the PCTrans loss stack in the dense point mode (mirror of
``pctrans_tpu/losses/criterion.py:51-428``).

Losses, with the JAX package's keys and weights:

* ``loss_mask[_l]`` / ``loss_dice[_l]``: sigmoid-CE and dice of every mask
  prediction (the final one and the ``dec_layers - 1`` earlier ones),
  evaluated at every pixel of the stride-4 logits with PointRend importance
  weights (``point_select="dense"``);
* ``loss_refpoints[_i]``: L1 between matched queries' reference points and
  the instance centres;
* ``loss_reid_query``, ``loss_reid_query_aux``, ``loss_reid_mask``: query
  contrast on the final layer;
* ``loss_sem``: focal loss on the foreground map at the logits' stride;
* ``loss_emb``: the discriminative embedding loss.

Matching runs without grad on the logits rounded to ``sample_dtype``, one
host assignment per (image, layer) lane (``ops/lap.py``).  The other point
modes ("shared", "weighted", "topk", "exact") come with ROADMAP item 25.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..ops.point_sample import kth_largest_threshold, sample_label_onehot_grid
from .contrast import cosine_similarity_matrix, pairwise_mask_dice, reid_losses
from .discriminative import discriminative_loss
from .matcher import dense_matcher_indices, softplus


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    """The fields of ``pctrans_tpu.losses.CriterionConfig`` that the dense
    mode reads, with the same defaults."""
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    refpoints_weight: float = 5.0
    reid_query_weight: float = 2.0
    reid_mask_weight: float = 2.0
    sem_weight: float = 5.0
    emb_weight: float = 2.0
    sem_loss_on: bool = True
    dec_layers: int = 10            # mask predictions: decoder layers + 1
    sample_dtype: str = "bfloat16"  # dtype of the matcher's cost terms


# configs/CVPPP/CVPPP-PCTrans{-Base,}.yaml on top of config/defaults.py, as
# pctrans_tpu.losses.build_criterion reads them: every field at its default
CVPPP_CRITERION = CriterionConfig()


def build_criterion_config(cfg) -> CriterionConfig:
    """CriterionConfig from a YACS-style config tree (the field mapping of
    ``pctrans_tpu.losses.build_criterion``); only the dense point mode."""
    mf = cfg.MODEL.MASK_FORMER
    tr = mf.TPU_RECIPE
    if tr.POINT_SELECT != "dense":
        raise NotImplementedError(
            f"TPU_RECIPE.POINT_SELECT {tr.POINT_SELECT!r}: the port has the "
            "dense mode only; the other modes are ROADMAP item 25")
    return CriterionConfig(
        num_points=mf.TRAIN_NUM_POINTS, oversample_ratio=mf.OVERSAMPLE_RATIO,
        importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO,
        mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT,
        refpoints_weight=mf.REF_POINTS_WEIGHT,
        reid_query_weight=mf.REID_WEIGHT_QUERY,
        reid_mask_weight=mf.REID_WEIGHT_MASK, sem_weight=mf.SEM_WEIGHT,
        emb_weight=mf.EMB_WEIGHT, sem_loss_on=mf.SEMANTIC_LOSS_ON,
        dec_layers=mf.DEC_LAYERS, sample_dtype=tr.SAMPLE_DTYPE)


def bce_logits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return softplus(-x) * y + softplus(x) * (1.0 - y)


class SetCriterion:
    def __init__(self, config: CriterionConfig):
        self.cfg = config
        self.sample_dtype = getattr(torch, config.sample_dtype)

    def mask_losses(self, stacked: torch.Tensor, tgt_dense: torch.Tensor,
                    indices: torch.Tensor, valid: torch.Tensor,
                    num_masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """CE + dice per layer at every pixel with PointRend importance
        weights (``criterion.py:160-188``).  stacked [L, B, Q, h, w];
        tgt_dense [B, G, h*w]; indices [L, B, G].  Returns ([L], [L])."""
        c = self.cfg
        L, B, Q, h, w = stacked.shape
        G = indices.shape[-1]
        P = h * w
        logits = torch.gather(stacked.reshape(L, B, Q, P), 2,
                              indices[..., None].expand(L, B, G, P)).float()
        uncert = -logits.detach().abs()
        k_q = max(int(P * c.importance_sample_ratio / c.oversample_ratio), 1)
        sel = uncert >= kth_largest_threshold(uncert, k_q)
        n_sel = sel.sum(-1, keepdim=True).float()
        w_sel = c.importance_sample_ratio * c.num_points / n_sel.clamp(min=1.0)
        w_fill = (1.0 - c.importance_sample_ratio) * c.num_points / P
        wp = torch.where(sel, w_sel, 0.0) + w_fill

        y = tgt_dense[None]
        denom = wp.sum(-1).clamp(min=1.0)
        ce = (wp * bce_logits(logits, y)).sum(-1) / denom
        sig = torch.sigmoid(logits)
        dice = 1.0 - (2.0 * (wp * sig * y).sum(-1) + 1.0) / (
            (wp * sig).sum(-1) + (wp * y).sum(-1) + 1.0)
        v = valid.float()
        return (ce * v).sum((1, 2)) / num_masks, (dice * v).sum((1, 2)) / num_masks

    @staticmethod
    def refpoints_losses(coords: torch.Tensor, centers: torch.Tensor,
                         indices: torch.Tensor, valid: torch.Tensor,
                         num_masks: torch.Tensor) -> torch.Tensor:
        """L1 on matched reference points (``criterion.py:281-285``).
        coords [L', B, Q, 2], indices [L', B, G] -> [L']."""
        src = torch.gather(coords, 2, indices[..., None].expand(-1, -1, -1, 2))
        l1 = (src - centers[None]).abs().sum(-1)
        return (l1 * valid).sum((1, 2)) / num_masks

    @staticmethod
    def sem_loss(sem_logits: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
        """Focal loss on the foreground map subsampled at the logits' stride
        (``criterion.py:287-300``)."""
        Hs = sem_logits.shape[1]
        stride = fg.shape[1] // Hs
        tgt = fg[:, stride // 2::stride, stride // 2::stride][..., None]
        tgt = tgt.to(sem_logits.dtype)
        num_pos = (tgt > 0).sum().to(sem_logits.dtype).clamp(min=1.0)
        p = torch.sigmoid(sem_logits)
        ce = bce_logits(sem_logits, tgt)
        p_t = p * tgt + (1 - p) * (1 - tgt)
        alpha_t = 0.25 * tgt + 0.75 * (1 - tgt)
        return (alpha_t * ce * (1 - p_t) ** 2).sum() / num_pos

    @torch.no_grad()
    def match(self, stacked: torch.Tensor, targets: Dict
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense matching of every mask prediction (``criterion.py:319-348``).
        stacked [L, B, Q, h, w] -> (indices [L, B, G], tgt_dense [B, G, h*w])."""
        c = self.cfg
        L, B, Q, h, w = stacked.shape
        valid = targets["valid"]
        G = valid.shape[1]
        tgt_dense = sample_label_onehot_grid(targets["seg"], (h, w), G).reshape(B, G, h * w)
        # (B, L) lanes, B major, as the JAX package merges them
        lanes = stacked.to(self.sample_dtype).transpose(0, 1).reshape(B * L, Q, h, w)
        indices = dense_matcher_indices(
            lanes, tgt_dense[:, None].expand(B, L, G, h * w).reshape(B * L, G, h * w),
            valid[:, None].expand(B, L, G).reshape(B * L, G),
            c.mask_weight, c.dice_weight)
        return indices.reshape(B, L, G).transpose(0, 1), tgt_dense

    def __call__(self, outputs: Dict, targets: Dict, reid_uniform: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """Returns (weighted total, dict of the raw losses, indices [L, B, G]).

        ``reid_uniform`` [B, G, Q]: uniform draws that pick the sampled
        negatives of ``loss_reid_query_aux``."""
        c = self.cfg
        all_masks = outputs["aux_masks"] + [outputs["pred_masks"]]
        L = len(all_masks)
        if L != c.dec_layers:
            raise ValueError(f"{L} mask predictions, the criterion expects "
                             f"{c.dec_layers}")
        valid = targets["valid"]
        stacked = torch.stack(all_masks)
        indices, tgt_dense = self.match(stacked, targets)
        num_masks = valid.sum().float().clamp(min=1.0)
        losses: Dict[str, torch.Tensor] = {}
        weights: Dict[str, float] = {}

        lm, ld = self.mask_losses(stacked, tgt_dense, indices, valid, num_masks)
        for l in range(L):
            mk, dk = ("loss_mask", "loss_dice") if l == L - 1 else (
                f"loss_mask_{l}", f"loss_dice_{l}")
            losses[mk], losses[dk] = lm[l], ld[l]
            weights[mk], weights[dk] = c.mask_weight, c.dice_weight

        # aux layer i's coords pair with layer i's indices, i >= 1
        # (criterion.py:386-400); the final coords with the final indices
        coords = torch.stack(list(outputs["aux_reference_points"])
                             + [outputs["reference_points"]]).float()
        rp = self.refpoints_losses(coords, targets["center_points"], indices[1:],
                                   valid, num_masks)
        for i in range(1, L - 1):
            losses[f"loss_refpoints_{i}"] = rp[i - 1]
            weights[f"loss_refpoints_{i}"] = c.refpoints_weight
        losses["loss_refpoints"] = rp[-1]
        weights["loss_refpoints"] = c.refpoints_weight

        query = outputs["query_emb"]
        cq, aq, cm, n_items = reid_losses(
            query, cosine_similarity_matrix(query),
            pairwise_mask_dice(outputs["pred_masks"]), indices[-1], valid,
            reid_uniform)
        denom = n_items.sum().float().clamp(min=1.0)
        losses["loss_reid_query"] = cq.sum() / denom
        losses["loss_reid_query_aux"] = aq.sum() / denom
        losses["loss_reid_mask"] = cm.sum() / denom
        weights["loss_reid_query"] = c.reid_query_weight
        weights["loss_reid_query_aux"] = c.reid_query_weight * 1.5
        weights["loss_reid_mask"] = c.reid_mask_weight

        if c.sem_loss_on and outputs.get("sem_mask") is not None:
            losses["loss_sem"] = self.sem_loss(outputs["sem_mask"], targets["fg_mask"])
            weights["loss_sem"] = c.sem_weight

        losses["loss_emb"] = discriminative_loss(
            outputs["mask_features"], targets["seg"], valid.shape[1])
        weights["loss_emb"] = c.emb_weight

        total = sum(losses[k] * weights[k] for k in losses)
        return total, losses, indices
