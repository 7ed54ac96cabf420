"""SetCriterion: the PCTrans loss stack (mirror of
``pctrans_tpu/losses/criterion.py:51-428``).

Losses, with the JAX package's keys and weights:

* ``loss_mask[_l]`` / ``loss_dice[_l]``: sigmoid-CE and dice of every mask
  prediction (the final one and the ``dec_layers - 1`` earlier ones), by
  ``point_select``:

  - ``dense``: at every pixel of the mask logits with PointRend importance
    weights;
  - ``shared``: at uniform candidates shared by an image's masks, selection
    as weights, targets from the full-resolution label map;
  - ``weighted``: at per-mask candidates, selection as weights;
  - ``topk``: the reference's select-then-sample with the JAX package's
    approximate top-k as XLA runs it off the TPU;
  - ``exact``: the reference's PointRend sampling with an exact top-k
    (with ``exact_targets``, ``candidate_ratio`` 3, f32 sampling and
    ``UPSAMPLE2X``: the published training estimator);

* ``loss_refpoints[_i]``: L1 between matched queries' reference points and
  the instance centres;
* ``loss_reid_query``, ``loss_reid_query_aux``, ``loss_reid_mask``: query
  contrast on the final layer;
* ``loss_sem``: focal loss on the foreground map at the logits' stride;
* ``loss_emb``: the discriminative embedding loss.

Matching runs without grad on the logits rounded to ``sample_dtype``, one
host assignment per (image, layer) lane (``ops/lap.py``): on the logits'
grid in the dense mode, at uniform points shared by an image's masks in the
others.  Every uniform draw comes in as a tensor (:meth:`SetCriterion.draws`
makes them in the shapes the JAX package draws them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import mesh
from .point_sample import (get_uncertain_point_coords, grid_sample_bilinear,
                                kth_largest_threshold, point_sample,
                                sample_label_onehot, sample_label_onehot_grid,
                                uncertain_point_weights)
from .contrast import cosine_similarity_matrix, pairwise_mask_dice, reid_losses
from .discriminative import discriminative_loss
from .matcher import dense_matcher_costs, point_matcher_costs, softplus

POINT_SELECT = ("dense", "shared", "weighted", "topk", "exact")


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    """``pctrans_tpu.losses.CriterionConfig``, with the same defaults."""
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
    sample_dtype: str = "bfloat16"  # dtype of the point sampling and matcher costs
    exact_targets: bool = False     # full-resolution targets (else stride 2)
    point_select: str = "dense"     # one of POINT_SELECT
    candidate_ratio: float = 1.0    # the shared mode's candidates per num_points

    def __post_init__(self):
        if self.point_select not in POINT_SELECT:
            raise ValueError(f"point_select {self.point_select!r}: one of {POINT_SELECT}")


# configs/CVPPP/CVPPP-PCTrans{-Base,}.yaml on top of config/defaults.py, as
# pctrans_tpu.losses.build_criterion reads them: every field at its default
CVPPP_CRITERION = CriterionConfig()


def build_criterion_config(cfg) -> CriterionConfig:
    """CriterionConfig from a YACS-style config tree (the field mapping of
    ``pctrans_tpu.losses.build_criterion``)."""
    mf = cfg.MODEL.MASK_FORMER
    tr = mf.TPU_RECIPE
    return CriterionConfig(
        num_points=mf.TRAIN_NUM_POINTS, oversample_ratio=mf.OVERSAMPLE_RATIO,
        importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO,
        mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT,
        refpoints_weight=mf.REF_POINTS_WEIGHT,
        reid_query_weight=mf.REID_WEIGHT_QUERY,
        reid_mask_weight=mf.REID_WEIGHT_MASK, sem_weight=mf.SEM_WEIGHT,
        emb_weight=mf.EMB_WEIGHT, sem_loss_on=mf.SEMANTIC_LOSS_ON,
        dec_layers=mf.DEC_LAYERS, sample_dtype=tr.SAMPLE_DTYPE,
        exact_targets=tr.EXACT_TARGETS, point_select=tr.POINT_SELECT,
        candidate_ratio=tr.CANDIDATE_RATIO)


def bce_logits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return softplus(-x) * y + softplus(x) * (1.0 - y)


def weighted_point_losses(wp: torch.Tensor, logits: torch.Tensor,
                          labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-mask weighted sigmoid-CE and dice over the last (point) axis
    (``criterion.py:145-155``)."""
    denom = wp.sum(-1).clamp(min=1.0)
    ce = (wp * bce_logits(logits, labels)).sum(-1) / denom
    sig = torch.sigmoid(logits)
    dice = 1.0 - (2.0 * (wp * sig * labels).sum(-1) + 1.0) / (
        (wp * sig).sum(-1) + (wp * labels).sum(-1) + 1.0)
    return ce, dice


def importance_weights(uncert: torch.Tensor, c: CriterionConfig) -> torch.Tensor:
    """The dense and shared modes' PointRend weights over P candidates
    (``criterion.py:176-186, 209-225``): the top (imp / oversample)
    uncertainty quantile carries the selected mass imp * num_points, and
    every candidate, selected ones included, carries the fill's share."""
    P = uncert.shape[-1]
    k_q = max(int(P * c.importance_sample_ratio / c.oversample_ratio), 1)
    sel = uncert >= kth_largest_threshold(uncert, k_q)
    n_sel = sel.sum(-1, keepdim=True).float()
    w_sel = c.importance_sample_ratio * c.num_points / n_sel.clamp(min=1.0)
    w_fill = (1.0 - c.importance_sample_ratio) * c.num_points / P
    return torch.where(sel, w_sel, 0.0) + w_fill


def _lanes_to_images(t: torch.Tensor, L: int) -> torch.Tensor:
    """[L * N, P, ...] -> [N, L * P, ...]: every layer's points of one image
    in one row, so that a map shared by the layers is sampled once."""
    N = t.shape[0] // L
    return t.reshape(L, N, *t.shape[1:]).transpose(0, 1).reshape(N, -1, *t.shape[2:])


def _images_to_lanes(t: torch.Tensor, L: int) -> torch.Tensor:
    """[N, C, L * P] -> [L * N, C, P], the inverse of ``_lanes_to_images``."""
    N, C = t.shape[:2]
    return t.reshape(N, C, L, -1).permute(2, 0, 1, 3).reshape(L * N, C, -1)


class SetCriterion:
    def __init__(self, config: CriterionConfig):
        self.cfg = config
        self.sample_dtype = getattr(torch, config.sample_dtype)

    def draws(self, batch: int, max_instances: int, num_queries: int,
              generator: Optional[torch.Generator] = None, device=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step's uniform draws, in the shapes the JAX criterion draws
        them: the re-id negatives' [B, G, Q] and the point modes' dict
        (``criterion.py:315-316, 363``, ``point_sample.py:168, 173, 259``,
        ``matcher.py:59, 113``):

        * ``match`` [L, B, 1, num_points, 2]: the matcher's points;
        * ``points``: candidates, (L, 2, B, num_points * candidate_ratio)
          in the shared mode, (L, 2, B * G, num_points * oversample_ratio)
          in the others;
        * ``fill`` [L, B * G, num_random, 2]: topk and exact only."""
        c = self.cfg
        L, B, G = c.dec_layers, batch, max_instances

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=device)

        reid = uniform(B, G, num_queries)
        draws: Dict[str, torch.Tensor] = {}
        if c.point_select == "dense":
            return reid, draws
        draws["match"] = uniform(L, B, 1, c.num_points, 2)
        if c.point_select == "shared":
            draws["points"] = uniform(L, 2, B, int(c.num_points * c.candidate_ratio))
            return reid, draws
        draws["points"] = uniform(L, 2, B * G, int(c.num_points * c.oversample_ratio))
        if c.point_select in ("topk", "exact"):
            num_random = c.num_points - int(c.importance_sample_ratio * c.num_points)
            draws["fill"] = uniform(L, B * G, num_random, 2)
        return reid, draws

    def mask_losses(self, stacked: torch.Tensor, tgt_dense: torch.Tensor,
                    indices: torch.Tensor, valid: torch.Tensor,
                    num_masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense mode: CE + dice per layer at every pixel with PointRend
        importance weights (``criterion.py:160-188``).  stacked [L, B, Q, h, w];
        tgt_dense [B, G, h*w]; indices [L, B, G].  Returns ([L], [L])."""
        L, B, Q, h, w = stacked.shape
        G = indices.shape[-1]
        P = h * w
        logits = torch.gather(stacked.reshape(L, B, Q, P), 2,
                              indices[..., None].expand(L, B, G, P)).float()
        wp = importance_weights(-logits.detach().abs(), self.cfg)
        ce, dice = weighted_point_losses(wp, logits, tgt_dense[None])
        v = valid.float()
        return (ce * v).sum((1, 2)) / num_masks, (dice * v).sum((1, 2)) / num_masks

    @staticmethod
    def _matched(stacked: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """The matched queries' logits: [L, B, Q, h, w] -> [L, B, G, h, w]."""
        L, B, Q, h, w = stacked.shape
        G = indices.shape[-1]
        return torch.gather(stacked, 2, indices[..., None, None].expand(L, B, G, h, w))

    def mask_losses_shared(self, stacked: torch.Tensor, seg: torch.Tensor,
                           indices: torch.Tensor, valid: torch.Tensor,
                           num_masks: torch.Tensor, points: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shared mode (``criterion.py:190-234``): an image's G matched
        masks sampled at its candidates ``points`` (L, 2, B, P) as channels
        of one map (G > 8: the generator rounding), weights from the sampled
        logits, targets from the full-resolution label map ``seg``."""
        L, B, Q, h, w = stacked.shape
        G = indices.shape[-1]
        P = points.shape[-1]
        src = self._matched(stacked, indices).to(self.sample_dtype)
        cx, cy = points[:, 0], points[:, 1]                          # [L, B, P]
        logits = grid_sample_bilinear(
            src.reshape(L * B, G, h, w), (cx * w - 0.5).reshape(L * B, P),
            (cy * h - 0.5).reshape(L * B, P)).float()                # [L*B, G, P]
        wp = importance_weights(-logits.detach().abs(), self.cfg)
        coords = torch.stack([cx, cy], -1).reshape(L * B, P, 2)
        labels = _images_to_lanes(
            sample_label_onehot(seg, _lanes_to_images(coords, L), G), L)
        ce, dice = weighted_point_losses(wp, logits, labels)
        v = valid.float()
        return ((ce.reshape(L, B, G) * v).sum((1, 2)) / num_masks,
                (dice.reshape(L, B, G) * v).sum((1, 2)) / num_masks)

    def mask_losses_sampled(self, stacked: torch.Tensor, tgt_masks: torch.Tensor,
                            indices: torch.Tensor, valid: torch.Tensor,
                            num_masks: torch.Tensor, points: torch.Tensor,
                            fill: Optional[torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The weighted, topk and exact modes (``criterion.py:236-279``):
        each matched mask sampled at its own points, which the uncertainty
        of its stride-2 view picks (in every mode, ``:250``) among the
        candidates ``points`` (L, 2, B * G, S); ``fill`` [L, B * G, R, 2]
        tops the top-k up.  tgt_masks [B, G, th, tw]."""
        c = self.cfg
        L, B, Q, h, w = stacked.shape
        G = indices.shape[-1]
        N = B * G
        src = self._matched(stacked, indices).reshape(L * N, 1, h, w).to(self.sample_dtype)
        tgt = tgt_masks.reshape(N, 1, *tgt_masks.shape[2:]).to(self.sample_dtype)
        th, tw = tgt.shape[-2:]
        src_est = src.detach()[:, :, ::2, ::2]
        cand = points.transpose(0, 1).reshape(2, L * N, -1)
        if c.point_select == "weighted":
            cx, cy, wp = uncertain_point_weights(
                src_est, c.num_points, c.oversample_ratio,
                c.importance_sample_ratio, cand)
            xy = _lanes_to_images(torch.stack([cx * tw - 0.5, cy * th - 0.5], -1), L)
            labels = _images_to_lanes(
                grid_sample_bilinear(tgt, xy[..., 0], xy[..., 1]), L)[:, 0].float()
            logits = grid_sample_bilinear(src, cx * w - 0.5, cy * h - 0.5)[:, 0].float()
            ce, dice = weighted_point_losses(wp, logits, labels)
        else:
            coords = get_uncertain_point_coords(
                src_est, c.num_points, c.oversample_ratio, c.importance_sample_ratio,
                cand, fill.reshape(L * N, *fill.shape[2:]),
                exact_topk=c.point_select == "exact")
            labels = _images_to_lanes(
                point_sample(tgt, _lanes_to_images(coords, L)), L)[:, 0].float()
            logits = point_sample(src, coords)[:, 0].float()
            ce = bce_logits(logits, labels).mean(1)
            sig = torch.sigmoid(logits)
            dice = 1.0 - (2.0 * (sig * labels).sum(1) + 1.0) / (
                sig.sum(1) + labels.sum(1) + 1.0)
        v = valid.reshape(-1).float()
        return ((ce.reshape(L, N) * v).sum(1) / num_masks,
                (dice.reshape(L, N) * v).sum(1) / num_masks)

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
    def sem_loss(sem_logits: torch.Tensor, fg: torch.Tensor,
                 world: int = 1) -> torch.Tensor:
        """Focal loss on the foreground map subsampled at the logits' stride
        (``criterion.py:287-300``), over the global count of positives."""
        Hs = sem_logits.shape[1]
        stride = fg.shape[1] // Hs
        tgt = fg[:, stride // 2::stride, stride // 2::stride][..., None]
        tgt = tgt.to(sem_logits.dtype)
        num_pos = (mesh.global_sum((tgt > 0).sum().to(sem_logits.dtype)).clamp(min=1.0)
                   / world)
        p = torch.sigmoid(sem_logits)
        ce = bce_logits(sem_logits, tgt)
        p_t = p * tgt + (1 - p) * (1 - tgt)
        alpha_t = 0.25 * tgt + 0.75 * (1 - tgt)
        return (alpha_t * ce * (1 - p_t) ** 2).sum() / num_pos

    @torch.no_grad()
    def match_with_costs(self, stacked: torch.Tensor, targets: Dict,
                         point_draws: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Matching of every mask prediction (``criterion.py:319-363``).
        stacked [L, B, Q, h, w] -> (indices [L, B, G], costs [L, B, Q, G] f32,
        tgt_dense [B, G, h*w] in the dense mode, else None).

        Dense: costs on the logits' grid.  Otherwise at the uniform points
        ``point_draws["match"]`` [L, B, 1, P, 2], shared by an image's masks,
        against targets from the full-resolution label map."""
        c = self.cfg
        L, B, Q, h, w = stacked.shape
        valid = targets["valid"]
        G = valid.shape[1]
        lanes = stacked.to(self.sample_dtype)
        if c.point_select == "dense":
            tgt_dense = sample_label_onehot_grid(targets["seg"], (h, w), G).reshape(
                B, G, h * w)
            # (B, L) lanes, B major, as the JAX package merges them
            indices, costs = dense_matcher_costs(
                lanes.transpose(0, 1).reshape(B * L, Q, h, w),
                tgt_dense[:, None].expand(B, L, G, h * w).reshape(B * L, G, h * w),
                valid[:, None].expand(B, L, G).reshape(B * L, G),
                c.mask_weight, c.dice_weight)
            return (indices.reshape(B, L, G).transpose(0, 1),
                    costs.reshape(B, L, Q, G).transpose(0, 1), tgt_dense)
        seg = targets["seg"]
        indices, costs = point_matcher_costs(
            lanes.reshape(L * B, Q, h, w),
            seg[None].expand(L, *seg.shape).reshape(L * B, *seg.shape[1:]),
            valid[None].expand(L, B, G).reshape(L * B, G),
            point_draws["match"].reshape(L * B, -1, 2), c.mask_weight, c.dice_weight)
        return indices.reshape(L, B, G), costs.reshape(L, B, Q, G), None

    def match(self, stacked: torch.Tensor, targets: Dict,
              point_draws: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(indices [L, B, G], tgt_dense) of :meth:`match_with_costs`."""
        indices, _, tgt_dense = self.match_with_costs(stacked, targets, point_draws)
        return indices, tgt_dense

    def __call__(self, outputs: Dict, targets: Dict, reid_uniform: torch.Tensor,
                 point_draws: Optional[Dict[str, torch.Tensor]] = None,
                 indices: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """Returns (weighted total, dict of the raw losses, indices [L, B, G]).

        ``reid_uniform`` [B, G, Q]: uniform draws that pick the sampled
        negatives of ``loss_reid_query_aux``; ``point_draws``: the point
        modes' draws (:meth:`draws`).  ``indices`` [L, B, G], when given,
        stands in for the matching."""
        c = self.cfg
        all_masks = outputs["aux_masks"] + [outputs["pred_masks"]]
        L = len(all_masks)
        if L != c.dec_layers:
            raise ValueError(f"{L} mask predictions, the criterion expects "
                             f"{c.dec_layers}")
        if c.point_select != "dense" and not point_draws:
            raise ValueError(f"point_select {c.point_select!r} needs point_draws")
        valid = targets["valid"]
        stacked = torch.stack(all_masks)
        tgt_dense = None
        if indices is None:
            indices, tgt_dense = self.match(stacked, targets, point_draws)
        # the global batch's count over the ranks, as JAX's ``valid.sum()``
        # over the batch-sharded mesh; each rank's term is then
        # world * (its sum) / (the global count), so the mean over ranks
        # (DDP's rule for the gradient) is the global batch's term
        world = mesh.world_size()
        num_masks = mesh.global_sum(valid.sum().float()).clamp(min=1.0) / world
        losses: Dict[str, torch.Tensor] = {}
        weights: Dict[str, float] = {}

        if c.point_select == "dense":
            if tgt_dense is None:
                h, w = stacked.shape[-2:]
                tgt_dense = sample_label_onehot_grid(
                    targets["seg"], (h, w), valid.shape[1]).reshape(*valid.shape, h * w)
            lm, ld = self.mask_losses(stacked, tgt_dense, indices, valid, num_masks)
        elif c.point_select == "shared":
            lm, ld = self.mask_losses_shared(stacked, targets["seg"], indices, valid,
                                             num_masks, point_draws["points"])
        else:
            tgt = targets["masks"] if c.exact_targets else targets["masks"][:, :, ::2, ::2]
            lm, ld = self.mask_losses_sampled(stacked, tgt, indices, valid, num_masks,
                                              point_draws["points"],
                                              point_draws.get("fill"))
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
        denom = mesh.global_sum(n_items.sum().float()).clamp(min=1.0) / world
        losses["loss_reid_query"] = cq.sum() / denom
        losses["loss_reid_query_aux"] = aq.sum() / denom
        losses["loss_reid_mask"] = cm.sum() / denom
        weights["loss_reid_query"] = c.reid_query_weight
        weights["loss_reid_query_aux"] = c.reid_query_weight * 1.5
        weights["loss_reid_mask"] = c.reid_mask_weight

        if c.sem_loss_on and outputs.get("sem_mask") is not None:
            losses["loss_sem"] = self.sem_loss(outputs["sem_mask"], targets["fg_mask"],
                                               world)
            weights["loss_sem"] = c.sem_weight

        # a mean over this rank's images: the global mean only when every
        # rank holds as many (the train step checks it)
        losses["loss_emb"] = discriminative_loss(
            outputs["mask_features"], targets["seg"], valid.shape[1])
        weights["loss_emb"] = c.emb_weight

        total = sum(losses[k] * weights[k] for k in losses)
        return total, losses, indices
