"""Optimizers, LR schedules and gradient clipping (mirror of
``pctrans_tpu/engine/solver.py``).

``SolverConfig`` carries the ``SOLVER`` fields; ``CVPPP_SOLVER`` is what
``configs/CVPPP/CVPPP-PCTrans{-Base,}.yaml`` set (AdamW, WarmupPolyLR).

* Optimizers: AdamW with three parameter groups (weights, biases, norm
  parameters: ``WEIGHT_DECAY``, ``_BIAS``, ``_NORM``), Adam, SGD with
  ``MOMENTUM``; Adam and SGD take no weight decay, as in optax.
* Schedules: ``lr_factor(step, s)`` is BASE_LR's multiple at update
  ``step`` (0-based): WarmupPolyLR, WarmupCosineLR, (Warmup)MultiStepLR,
  OneCycle (the JAX formula: no momentum cycling), and ReduceLROnPlateau's
  constant BASE_LR; linear or constant warmup; from ``SWA.START_ITER`` the
  SWA rate ``LR_FACTOR * BASE_LR``.
* ReduceLROnPlateau scales each update by the scale from before this step's
  loss (``:122-159``): ``SolverLR.observe(loss)`` after the optimizer step.
* ``clip_gradients``: ``optax.clip_by_global_norm`` (``full_model`` /
  ``norm``) or ``optax.clip`` (``value``) before the optimizer.

Unknown names raise ``ValueError``, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

NORM_TYPES = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)
OPTIMIZERS = ("AdamW", "Adam", "SGD")
SCHEDULES = ("WarmupPolyLR", "WarmupCosineLR", "WarmupMultiStepLR", "MultiStepLR",
             "OneCycle", "ReduceLROnPlateau")
WARMUP_METHODS = ("linear", "constant")
CLIP_TYPES = ("full_model", "norm", "value")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The ``SOLVER`` fields the optimizer, the schedule and the clipping
    read.  ``clip_type`` None is no clipping; ``swa_start_iter`` None is no
    SWA rate."""
    name: str = "AdamW"
    base_lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    momentum: float = 0.9
    weight_decay: float = 0.05
    weight_decay_norm: float = 0.0
    weight_decay_bias: float = 0.0
    lr_scheduler_name: str = "WarmupPolyLR"
    warmup_method: str = "linear"
    warmup_factor: float = 0.001
    warmup_iters: int = 1000
    poly_power: float = 0.9
    iteration_total: int = 30000
    steps: Tuple[int, ...] = (30000,)
    gamma: float = 0.1
    clip_type: Optional[str] = None
    clip_value: float = 0.01
    swa_start_iter: Optional[int] = None
    swa_lr_factor: float = 0.05

    def __post_init__(self):
        for value, known, key in ((self.name, OPTIMIZERS, "NAME"),
                                  (self.lr_scheduler_name, SCHEDULES, "LR_SCHEDULER_NAME"),
                                  (self.warmup_method, WARMUP_METHODS, "WARMUP_METHOD"),
                                  (self.clip_type, CLIP_TYPES + (None,),
                                   "CLIP_GRADIENTS.CLIP_TYPE")):
            if value not in known:
                raise ValueError(f"SOLVER.{key} {value!r}: one of {known}")


# the YAMLs set BASE_LR, WARMUP_FACTOR, WARMUP_ITERS, WEIGHT_DECAY and
# ITERATION_TOTAL to the defaults above
CVPPP_SOLVER = SolverConfig()


def build_solver_config(cfg) -> SolverConfig:
    """SolverConfig from a YACS-style config tree."""
    s = cfg.SOLVER
    clip = s.CLIP_GRADIENTS
    swa = s.get("SWA", None)
    return SolverConfig(
        name=s.NAME, base_lr=s.BASE_LR, betas=tuple(s.BETAS), momentum=s.MOMENTUM,
        weight_decay=s.WEIGHT_DECAY, weight_decay_norm=s.WEIGHT_DECAY_NORM,
        weight_decay_bias=s.WEIGHT_DECAY_BIAS, lr_scheduler_name=s.LR_SCHEDULER_NAME,
        warmup_method=s.WARMUP_METHOD, warmup_factor=s.WARMUP_FACTOR,
        warmup_iters=s.WARMUP_ITERS, poly_power=s.get("POLY_POWER", 0.9),
        iteration_total=s.ITERATION_TOTAL, steps=tuple(s.STEPS), gamma=s.GAMMA,
        clip_type=clip.CLIP_TYPE if clip.ENABLED else None, clip_value=clip.CLIP_VALUE,
        swa_start_iter=int(swa.START_ITER) if swa is not None and swa.ENABLED else None,
        swa_lr_factor=swa.LR_FACTOR if swa is not None else 0.05)


def parameter_groups(model: nn.Module) -> Dict[str, List[str]]:
    """Parameter names by the JAX package's ``_is_norm_or_bias_path``
    labels: ``norm`` (every parameter of a norm layer), ``bias`` (the other
    biases) and ``kernel`` (every other weight and embedding)."""
    groups: Dict[str, List[str]] = {"kernel": [], "bias": [], "norm": []}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            label = ("norm" if isinstance(mod, NORM_TYPES)
                     else "bias" if p_name == "bias" else "kernel")
            groups[label].append(f"{mod_name}.{p_name}" if mod_name else p_name)
    return groups


def decayed_parameter_names(model: nn.Module) -> List[str]:
    """Names of the parameters that ``WEIGHT_DECAY`` applies to (the
    ``kernel`` group)."""
    return parameter_groups(model)["kernel"]


def build_optimizer(model: nn.Module, s: SolverConfig) -> torch.optim.Optimizer:
    """The optimizer at ``BASE_LR``; :func:`build_lr_scheduler` sets the
    rate of every update."""
    params = list(model.parameters())
    if s.name == "Adam":
        return torch.optim.Adam(params, lr=s.base_lr, betas=tuple(s.betas), eps=1e-8)
    if s.name == "SGD":
        return torch.optim.SGD(params, lr=s.base_lr, momentum=s.momentum)
    named = dict(model.named_parameters())
    decay = {"kernel": s.weight_decay, "bias": s.weight_decay_bias,
             "norm": s.weight_decay_norm}
    groups = [{"params": [named[n] for n in names], "weight_decay": decay[label]}
              for label, names in parameter_groups(model).items() if names]
    return torch.optim.AdamW(groups, lr=s.base_lr, betas=tuple(s.betas), eps=1e-8)


def warmup_factor(step: int, method: str, warmup_iters: int, factor: float) -> float:
    """``warmup_factor_at`` (``:21-32``)."""
    if warmup_iters <= 0 or step >= warmup_iters:
        return 1.0
    if method == "constant":
        return factor
    alpha = step / warmup_iters
    return factor * (1 - alpha) + alpha


def warmup_poly_factor(step: int, s: SolverConfig) -> float:
    """WarmupPolyLR's multiple of BASE_LR at update ``step`` (0-based)."""
    wf = warmup_factor(step, s.warmup_method, s.warmup_iters, s.warmup_factor)
    frac = min(max(1.0 - step / s.iteration_total, 0.0), 1.0)
    return wf * frac ** s.poly_power


def _one_cycle(step: int, s: SolverConfig) -> float:
    """torch OneCycleLR's rate (cosine, div_factor 25, final_div_factor
    1000) at torch's phase boundaries, as ``:67-88`` writes it; over
    BASE_LR."""
    total = s.iteration_total
    pct_start = s.warmup_iters / max(total, 1)
    initial = 1.0 / 25.0
    final = initial / 1000.0
    up_end = max(pct_start * total - 1.0, 1e-9)
    down_len = max(total - 1.0 - up_end, 1e-9)

    def anneal(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    if step <= up_end:
        return anneal(initial, 1.0, min(max(step / up_end, 0.0), 1.0))
    return anneal(1.0, final, min(max((step - up_end) / down_len, 0.0), 1.0))


def lr_factor(step: int, s: SolverConfig) -> float:
    """BASE_LR's multiple at update ``step`` (0-based) by the configured
    schedule (``build_lr_schedule``, ``:35-117``), the plateau scale
    aside."""
    if s.swa_start_iter is not None and step >= s.swa_start_iter:
        return s.swa_lr_factor
    name = s.lr_scheduler_name
    if name == "WarmupPolyLR":
        return warmup_poly_factor(step, s)
    if name == "WarmupCosineLR":
        wf = warmup_factor(step, s.warmup_method, s.warmup_iters, s.warmup_factor)
        return wf * 0.5 * (1.0 + math.cos(math.pi * step / s.iteration_total))
    if name in ("WarmupMultiStepLR", "MultiStepLR"):
        iters = s.warmup_iters if name == "WarmupMultiStepLR" else 0
        wf = warmup_factor(step, s.warmup_method, iters, s.warmup_factor)
        return wf * s.gamma ** sum(step >= m for m in s.steps)
    if name == "OneCycle":
        return _one_cycle(step, s)
    return 1.0                                        # ReduceLROnPlateau


class SolverLR(torch.optim.lr_scheduler.LambdaLR):
    """Update n runs at ``BASE_LR * lr_factor(n) * scale``; step it once
    after every optimizer step.  ``scale`` is ReduceLROnPlateau's
    (``mode='min'``, ``threshold_mode='rel'``, threshold 1e-3, patience
    1000, no cooldown, factor GAMMA, floor 1e-6 / BASE_LR), 1 under the
    other schedules; ``observe(loss)`` before ``step()`` feeds it, so that
    the next update takes the scale this loss left."""

    PATIENCE, THRESHOLD = 1000, 1e-3

    def __init__(self, optimizer: torch.optim.Optimizer, s: SolverConfig):
        self.plateau = s.lr_scheduler_name == "ReduceLROnPlateau"
        self.gamma = s.gamma
        self.min_scale = 1e-6 / max(s.base_lr, 1e-12)
        self.scale, self.best, self.bad_count = 1.0, math.inf, 0
        super().__init__(optimizer, lambda step: lr_factor(step, s) * self.scale)

    def observe(self, loss: float) -> None:
        if not self.plateau:
            return
        if loss < self.best * (1.0 - self.THRESHOLD):
            self.best, self.bad_count = loss, 0
        else:
            self.bad_count += 1
        if self.bad_count > self.PATIENCE:
            self.scale = max(self.scale * self.gamma, self.min_scale)
            self.bad_count = 0


def build_lr_scheduler(optimizer: torch.optim.Optimizer, s: SolverConfig) -> SolverLR:
    return SolverLR(optimizer, s)


@torch.no_grad()
def clip_gradients(params: Iterable[torch.Tensor], s: SolverConfig) -> None:
    """Clip the gradients in place before the optimizer step: by the global
    L2 norm, ``g / norm * CLIP_VALUE`` where ``norm >= CLIP_VALUE``
    (``optax.clip_by_global_norm``; ``NORM_TYPE`` is not read, as in the
    JAX package), or each element to +-CLIP_VALUE (``optax.clip``)."""
    if s.clip_type is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if s.clip_type == "value":
        for g in grads:
            g.clamp_(-s.clip_value, s.clip_value)
        return
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < s.clip_value
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * s.clip_value))
