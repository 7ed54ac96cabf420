"""Optimizer and LR schedule of the recipe (mirror of
``pctrans_tpu/engine/solver.py:21-48, 162-214``): AdamW whose weight decay
skips norm parameters and biases, and WarmupPolyLR as a ``LambdaLR``.

``SolverConfig`` carries the ``SOLVER`` fields the port reads;
``CVPPP_SOLVER`` is what ``configs/CVPPP/CVPPP-PCTrans{-Base,}.yaml`` set.
``build_solver_config`` raises ``NotImplementedError`` (ROADMAP item 14)
for the other optimizers and schedules (ReduceLROnPlateau included),
gradient clipping, weight decay on norms or biases, and SWA.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

_TODO = "not ported yet (ROADMAP item 14)"
NORM_TYPES = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """AdamW with WarmupPolyLR (linear warmup); norm parameters and biases
    take no weight decay."""
    base_lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.05
    warmup_factor: float = 0.001
    warmup_iters: int = 1000
    poly_power: float = 0.9
    iteration_total: int = 30000


# the YAMLs set BASE_LR, WARMUP_FACTOR, WARMUP_ITERS, WEIGHT_DECAY and
# ITERATION_TOTAL to the defaults above
CVPPP_SOLVER = SolverConfig()


def build_solver_config(cfg) -> SolverConfig:
    """SolverConfig from a YACS-style config tree; raises for the settings
    the port does not have yet."""
    s = cfg.SOLVER
    unported = {
        "SOLVER.NAME": s.NAME != "AdamW",
        "SOLVER.LR_SCHEDULER_NAME": s.LR_SCHEDULER_NAME != "WarmupPolyLR",
        "SOLVER.WARMUP_METHOD": s.WARMUP_METHOD != "linear",
        "SOLVER.WEIGHT_DECAY_NORM / _BIAS": s.WEIGHT_DECAY_NORM != 0.0
        or s.WEIGHT_DECAY_BIAS != 0.0,
        "SOLVER.CLIP_GRADIENTS": bool(s.CLIP_GRADIENTS.ENABLED),
        "SOLVER.SWA": bool(s.get("SWA", None) and s.SWA.ENABLED),
    }
    for key, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{key}: {_TODO}")
    return SolverConfig(
        base_lr=s.BASE_LR, betas=tuple(s.BETAS), weight_decay=s.WEIGHT_DECAY,
        warmup_factor=s.WARMUP_FACTOR, warmup_iters=s.WARMUP_ITERS,
        poly_power=s.get("POLY_POWER", 0.9), iteration_total=s.ITERATION_TOTAL)


def decayed_parameter_names(model: nn.Module):
    """Names of the parameters that weight decay applies to: every weight
    and embedding, but no bias and no parameter of a norm layer (the JAX
    package's ``_is_norm_or_bias_path`` "kernel" labels)."""
    names = []
    for mod_name, mod in model.named_modules():
        if isinstance(mod, NORM_TYPES):
            continue
        for p_name, _ in mod.named_parameters(recurse=False):
            if p_name != "bias":
                names.append(f"{mod_name}.{p_name}" if mod_name else p_name)
    return names


def build_optimizer(model: nn.Module, s: SolverConfig) -> torch.optim.AdamW:
    decayed = set(decayed_parameter_names(model))
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if n in decayed],
         "weight_decay": s.weight_decay},
        {"params": [p for n, p in params.items() if n not in decayed],
         "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=s.base_lr, betas=tuple(s.betas), eps=1e-8)


def warmup_poly_factor(step: int, s: SolverConfig) -> float:
    """WarmupPolyLR's multiple of BASE_LR at update ``step`` (0-based), as
    the JAX package's ``build_lr_schedule`` gives it."""
    wf = 1.0
    if step < s.warmup_iters:
        alpha = step / s.warmup_iters
        wf = s.warmup_factor * (1 - alpha) + alpha
    frac = min(max(1.0 - step / s.iteration_total, 0.0), 1.0)
    return wf * frac ** s.poly_power


def build_lr_scheduler(optimizer: torch.optim.Optimizer, s: SolverConfig
                       ) -> torch.optim.lr_scheduler.LambdaLR:
    """Step it once after every optimizer step: update n then runs at
    ``BASE_LR * warmup_poly_factor(n)``."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: warmup_poly_factor(step, s))
