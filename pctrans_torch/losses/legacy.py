"""Legacy loss zoo, regularisers and the multi-target criterion (mirror of
``pctrans_tpu/losses/legacy.py``; reference connectomics/model/loss/
loss.py:9-295, regularization.py:9-160, criterion.py:15-218 and the channel
splitter of model/utils/misc.py:75-160).

Channel-first throughout ([B, C, *spatial]).  Every loss is a callable
config: ``loss(pred, target, weight_mask=None) -> scalar``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def get_functional_act(name: str) -> Callable:
    acts = {
        "none": lambda x: x,
        "sigmoid": torch.sigmoid,
        "softmax": lambda x: torch.softmax(x, dim=1),
        "tanh": torch.tanh,
    }
    return acts[name]


# ----------------------------------------------------------------------- losses


@dataclasses.dataclass
class DiceLoss:
    """loss.py:9-59: additive ``smooth``, per-sample dice averaged when
    ``reduce``."""

    reduce: bool = True
    smooth: float = 100.0
    power: int = 1

    def __call__(self, pred, target, weight_mask=None):
        if self.reduce:
            p = pred.reshape(pred.shape[0], -1)
            t = target.reshape(target.shape[0], -1)
            inter = (p * t).sum(-1)
            denom = (p ** self.power).sum(-1) + (t ** self.power).sum(-1)
            return (1 - (2 * inter + self.smooth) / (denom + self.smooth)).mean()
        p, t = pred.reshape(-1), target.reshape(-1)
        inter = (p * t).sum()
        denom = (p ** self.power).sum() + (t ** self.power).sum()
        return 1 - (2 * inter + self.smooth) / (denom + self.smooth)


@dataclasses.dataclass
class WeightedMSE:
    """loss.py:62-79: the weighted squared error summed over B * spatial."""

    def __call__(self, pred, target, weight_mask=None):
        norm = pred.shape[0] * pred[0, 0].numel()
        se = (pred - target) ** 2
        if weight_mask is not None:
            se = se * weight_mask
        return se.sum() / norm


@dataclasses.dataclass
class WeightedMAE:
    def __call__(self, pred, target, weight_mask=None):
        loss = (pred - target).abs()
        if weight_mask is not None:
            loss = loss * weight_mask
        return loss.mean()


def _bce(prob, target, eps=1e-7):
    prob = prob.clamp(eps, 1 - eps)
    return -(target * torch.log(prob) + (1 - target) * torch.log1p(-prob))


def _bce_with_logits(logits, target):
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


@dataclasses.dataclass
class WeightedBCE:
    """loss.py:94-104: probabilities in, an elementwise weight mask."""

    def __call__(self, pred, target, weight_mask=None):
        loss = _bce(pred, target)
        if weight_mask is not None:
            loss = loss * weight_mask
        return loss.mean()


@dataclasses.dataclass
class WeightedBCEWithLogitsLoss:
    eps: float = 0.0

    def __call__(self, pred, target, weight_mask=None):
        loss = _bce_with_logits(pred, target.clamp(self.eps, 1 - self.eps))
        if weight_mask is not None:
            loss = loss * weight_mask
        return loss.mean()


@dataclasses.dataclass
class WeightedCE:
    """loss.py:120-144: multi-class CE over channel 1 with optional class
    weights and an elementwise weight mask; targets are integer class maps
    [B, *spatial]."""

    class_weight: Optional[Sequence[float]] = None

    def __call__(self, pred, target, weight_mask=None):
        tgt = target.long()
        nll = -torch.log_softmax(pred, dim=1).gather(1, tgt.unsqueeze(1)).squeeze(1)
        if self.class_weight is not None:
            nll = nll * torch.tensor(self.class_weight, dtype=pred.dtype,
                                     device=pred.device)[tgt]
        if weight_mask is not None:
            nll = nll * weight_mask
        return nll.mean()


@dataclasses.dataclass
class WeightedLS:
    """Label-smoothing CE (loss.py:147-177)."""

    classes: int = 10
    cls_weights: Optional[Sequence[float]] = None
    smoothing: float = 0.2

    def __call__(self, pred, target, weight_mask=None):
        logp = torch.log_softmax(pred, dim=1)
        onehot = F.one_hot(target.long(), self.classes).movedim(-1, 1).to(pred.dtype)
        true = (onehot * (1.0 - self.smoothing)
                + (1 - onehot) * self.smoothing / (self.classes - 1))
        w = 1.0
        if self.cls_weights is not None:
            w = torch.tensor(self.cls_weights, dtype=pred.dtype, device=pred.device)
            w = w.reshape((1, self.classes) + (1,) * (pred.dim() - 2))
        loss = (-true * logp * w).sum(1)
        if weight_mask is not None:
            loss = loss * weight_mask
        return loss.mean()


@dataclasses.dataclass
class WeightedBCEFocalLoss:
    """loss.py:179-198: focal weighting on BCE-with-logits."""

    gamma: float = 2.0
    alpha: float = 0.25
    eps: float = 0.0

    def __call__(self, pred, target, weight_mask=None):
        prob = torch.sigmoid(pred)
        pt = (1 - target) * (1 - prob) + target * prob
        at = (1 - self.alpha) * target + self.alpha * (1 - target)
        wt = at * (1 - pt) ** self.gamma
        if weight_mask is not None:
            wt = wt * weight_mask
        return (wt * _bce_with_logits(pred, target.clamp(self.eps, 1 - self.eps))).mean()


@dataclasses.dataclass
class WSDiceLoss:
    """Weighted-soft dice (loss.py:201-224)."""

    smooth: float = 100.0
    power: float = 2.0
    v2: float = 0.85
    v1: float = 0.15

    def __call__(self, pred, target, weight_mask=None):
        p = pred.reshape(pred.shape[0], -1)
        t = target.reshape(pred.shape[0], -1)
        wt = t * (self.v2 - self.v1) + self.v1
        gp = wt * (2 * p - 1)
        g = wt * (2 * t - 1)
        inter = (gp * g).sum(-1)
        denom = (gp ** self.power).sum(-1) + (g ** self.power).sum(-1)
        return (1 - (2 * inter + self.smooth) / (denom + self.smooth)).mean()


@dataclasses.dataclass
class GANLoss:
    """loss.py:227-295: the vanilla / lsgan / wgangp objectives on a
    discriminator's logits."""

    gan_mode: str = "lsgan"
    target_real_label: float = 1.0
    target_fake_label: float = 0.0

    def __call__(self, prediction, target_is_real: bool):
        label = self.target_real_label if target_is_real else self.target_fake_label
        if self.gan_mode == "lsgan":
            return ((prediction - label) ** 2).mean()
        if self.gan_mode == "vanilla":
            return _bce_with_logits(prediction, torch.full_like(prediction, label)).mean()
        if self.gan_mode == "wgangp":
            return -prediction.mean() if target_is_real else prediction.mean()
        raise NotImplementedError(self.gan_mode)


# ------------------------------------------------------------- regularisers


@dataclasses.dataclass
class BinaryReg:
    """regularization.py:9-27: 1 / |sigmoid(x) - 0.5| pushes outputs to 0/1."""

    def __call__(self, pred, mask=None):
        loss = 1.0 / (torch.sigmoid(pred) - 0.5).abs().clamp(min=1e-2)
        if mask is not None:
            loss = loss * mask
        return loss.mean()


@dataclasses.dataclass
class ForegroundDTConsistency:
    """regularization.py:30-56: the foreground mask against the signed EDT."""

    def __call__(self, pred1, pred2, mask=None):
        dist = torch.tanh(pred2)
        loss = (-F.logsigmoid(pred1) * dist.clamp(min=0)
                - F.logsigmoid(-pred1) * (-dist.clamp(max=0)))
        if mask is not None:
            loss = loss * mask
        return loss.mean()


@dataclasses.dataclass
class ContourDTConsistency:
    """regularization.py:59-81: contour probability times |tanh(EDT)|,
    squared."""

    def __call__(self, pred1, pred2, mask=None):
        loss = (torch.sigmoid(pred1) * torch.tanh(pred2).abs()) ** 2
        if mask is not None:
            loss = loss * mask
        return loss.mean()


@dataclasses.dataclass
class FgContourConsistency:
    """regularization.py:84-132: the Sobel edge of the foreground
    probability (per z slice, zero padded), max-pooled over a
    (2 tsz_h + 1)^2 window, against the contour probability.  [B, C, Z, Y, X]."""

    tsz_h: int = 1
    eps: float = 1e-7

    def __call__(self, pred1, pred2, mask=None):
        fg = torch.sigmoid(pred1)
        contour = torch.sigmoid(pred2)
        fp = F.pad(fg, (1, 1))
        ex = fp[..., :-2] - fp[..., 2:]
        fp = F.pad(fg, (0, 0, 1, 1))
        ey = fp[..., :-2, :] - fp[..., 2:, :]
        edge = torch.sqrt(ex ** 2 + ey ** 2 + self.eps).clamp(self.eps, 1.0 - self.eps)
        sz, th = 2 * self.tsz_h + 1, self.tsz_h
        B, C, Z, Y, X = edge.shape
        edge = F.max_pool2d(edge.reshape(B * C * Z, 1, Y, X), sz, 1, th)
        loss = (edge.reshape(B, C, Z, Y, X) - contour) ** 2
        if mask is not None:
            loss = loss * mask
        return loss.mean()


@dataclasses.dataclass
class NonoverlapReg:
    """regularization.py:135-160: penalise pre- and post-synaptic overlap
    (channels 0 and 1), masked by the foreground (channel 2, no gradient)."""

    fg_masked: bool = True

    def __call__(self, pred):
        loss = torch.sigmoid(pred[:, 0]) * torch.sigmoid(pred[:, 1])
        if self.fg_masked:
            loss = loss * torch.sigmoid(pred[:, 2].detach())
        return loss.mean()


# ------------------------------------------------------------ split activation


class SplitActivation:
    """Splits the channels per target (+ optional activations)
    (model/utils/misc.py:75-160)."""

    num_channels_dict = {
        "0": 1, "8": 1, "1": 3, "2": 3, "3": 1, "4": 1, "5": 1, "6": 1,
        "7": 2, "all": -1,
    }

    def __init__(self, target_opt: Sequence[str] = ("0",),
                 output_act: Optional[Sequence[str]] = None,
                 split_only: bool = False, do_2d: bool = False):
        nc = dict(self.num_channels_dict)
        if do_2d:
            nc["2"] = 2
        self.target_opt = list(target_opt)
        self.split_channels: List[int] = []
        for i, topt in enumerate(self.target_opt):
            if topt == "all" and i < len(self.target_opt) - 1:
                raise ValueError("Only the last target can be 'all'")
            if topt == "all":
                self.split_channels.append(-1)
            elif topt[0] == "I":
                self.split_channels.append(int(topt.split("-")[1]) if "-" in topt else 1)
            elif topt[0] == "5" and "-" in topt:
                _, _mode, _padding, quant, _z_res = topt.split("-")
                self.split_channels.append(11 if bool(int(quant)) else 1)
            elif topt[0] == "9":
                self.split_channels.append(int(topt.split("-")[1]))
            else:
                self.split_channels.append(nc[topt[0]])
        self.split_only = split_only
        self.act = None
        if not split_only and output_act is not None:
            self.act = [get_functional_act(a) for a in output_act]

    def __call__(self, x):
        channels = list(self.split_channels)
        if channels[-1] == -1:
            channels[-1] = x.shape[1] - sum(channels[:-1])
        starts = [sum(channels[:i]) for i in range(len(channels))]
        parts = [x.narrow(1, s, c) for s, c in zip(starts, channels)]
        if self.split_only or self.act is None:
            return parts
        return [a(p) for a, p in zip(self.act, parts)]


# --------------------------------------------------------------- the criterion


class LegacyCriterion:
    """Multi-target loss dispatcher (reference Criterion, criterion.py:
    15-218): splits the prediction per TARGET_OPT, applies each target's
    activated losses with their weights, adds the regularisers and returns
    ``(total, per-term dict)``."""

    loss_dict = {
        "WeightedMSE": WeightedMSE, "WeightedMAE": WeightedMAE,
        "WeightedBCE": WeightedBCE, "DiceLoss": DiceLoss,
        "WeightedCE": WeightedCE,
        "WeightedBCEWithLogitsLoss": WeightedBCEWithLogitsLoss,
        "WeightedBCEFocalLoss": WeightedBCEFocalLoss,
        "WSDiceLoss": WSDiceLoss,
    }
    regu_dict = {
        "Binary": BinaryReg, "FgContour": FgContourConsistency,
        "ContourDT": ContourDTConsistency, "FgDT": ForegroundDTConsistency,
        "Nonoverlap": NonoverlapReg,
    }

    def __init__(self, target_opt: Sequence[str] = ("0",),
                 loss_opt: Sequence[Sequence[str]] = (("WeightedBCE",),),
                 output_act: Sequence[Sequence[str]] = (("none",),),
                 loss_weight: Sequence[Sequence[float]] = ((1.0,),),
                 loss_kwargs=None,
                 regu_opt: Optional[Sequence[str]] = None,
                 regu_target: Optional[Sequence[Sequence[int]]] = None,
                 regu_weight: Optional[Sequence[float]] = None,
                 do_2d: bool = False):
        self.target_opt = list(target_opt)
        self.splitter = SplitActivation(target_opt, split_only=True, do_2d=do_2d)
        self.loss_opt = [list(l) for l in loss_opt]
        self.loss_w = [list(w) for w in loss_weight]
        self.loss_fn = []
        for i, opts in enumerate(self.loss_opt):
            fns = []
            for j, lopt in enumerate(opts):
                params = None
                if loss_kwargs is not None and loss_kwargs[i] is not None:
                    params = loss_kwargs[i][j]
                fns.append(self.loss_dict[lopt](**(params or {})))
            self.loss_fn.append(fns)
        self.act = [[get_functional_act(a) for a in acts] for acts in output_act]
        self.regu_opt = list(regu_opt) if regu_opt else []
        self.regu_fn = [self.regu_dict[r]() for r in self.regu_opt]
        self.regu_t = [list(t) for t in (regu_target or [])]
        self.regu_w = list(regu_weight or [])

    def evaluate(self, pred, target, weight, key=None,
                 losses_vis=None) -> Tuple[torch.Tensor, Dict]:
        losses_vis = {} if losses_vis is None else losses_vis
        x = self.splitter(pred)
        loss = 0.0
        for i in range(len(self.target_opt)):
            for j in range(len(self.loss_fn[i])):
                w_mask = None
                if weight is not None and weight[i][j] is not None:
                    wm = torch.as_tensor(weight[i][j], device=pred.device)
                    # the no-weight placeholder is a size-1 array (criterion.py:18)
                    if wm.numel() > 1:
                        w_mask = wm
                term = self.loss_w[i][j] * self.loss_fn[i][j](
                    self.act[i][j](x[i]), torch.as_tensor(target[i], device=pred.device),
                    weight_mask=w_mask)
                loss = loss + term
                tag = f"{self.target_opt[i]}_{self.loss_opt[i][j]}_{i}"
                losses_vis[tag if key is None else f"{tag}_{key}"] = term
        for i, rfn in enumerate(self.regu_fn):
            term = self.regu_w[i] * rfn(*[x[j] for j in self.regu_t[i]])
            loss = loss + term
            names = "_".join(self.target_opt[j] for j in self.regu_t[i])
            tag = f"{names}_{self.regu_opt[i]}_{i}"
            losses_vis[tag if key is None else f"{tag}_{key}"] = term
        return loss, losses_vis

    def __call__(self, pred, target, weight=None):
        if isinstance(pred, dict):      # a DeepLab-style {"out", "aux"} dict
            loss, losses_vis = 0.0, {}
            for key in pred:
                t, losses_vis = self.evaluate(pred[key], target, weight, key, losses_vis)
                loss = loss + t
            return loss, losses_vis
        return self.evaluate(pred, target, weight)

    @classmethod
    def build_from_cfg(cls, cfg):
        """criterion.py:191-218."""
        loss_kwargs = None
        if getattr(cfg.MODEL, "LOSS_KWARGS_KEY", None):
            keys, vals = cfg.MODEL.LOSS_KWARGS_KEY, cfg.MODEL.LOSS_KWARGS_VAL
            loss_kwargs = [
                [dict(zip(k, v)) if k else None for k, v in zip(ks, vs)]
                if ks else None for ks, vs in zip(keys, vals)
            ]
        return cls(cfg.MODEL.TARGET_OPT, cfg.MODEL.LOSS_OPTION,
                   cfg.MODEL.OUTPUT_ACT, cfg.MODEL.LOSS_WEIGHT, loss_kwargs,
                   getattr(cfg.MODEL, "REGU_OPT", None),
                   getattr(cfg.MODEL, "REGU_TARGET", None),
                   getattr(cfg.MODEL, "REGU_WEIGHT", None),
                   do_2d=cfg.DATASET.DO_2D)
