"""AdamW with the JAX package's parameter groups and the WarmupPolyLR
schedule: a trimmed copy of the port's ``engine/solver.py``, the recipe's
optimizer and schedule only."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn

NORM_TYPES = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    name: str = "AdamW"
    base_lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.05
    weight_decay_norm: float = 0.0
    weight_decay_bias: float = 0.0
    lr_scheduler_name: str = "WarmupPolyLR"
    warmup_method: str = "linear"
    warmup_factor: float = 0.001
    warmup_iters: int = 1000
    poly_power: float = 0.9
    iteration_total: int = 30000

    def __post_init__(self):
        if (self.name, self.lr_scheduler_name, self.warmup_method) != (
                "AdamW", "WarmupPolyLR", "linear"):
            raise ValueError("the reference solver is AdamW with a linear-warmup "
                             f"WarmupPolyLR, not {self.name} / {self.lr_scheduler_name} "
                             f"/ {self.warmup_method}")

    @classmethod
    def from_sizes(cls, sizes: dict) -> "SolverConfig":
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in sizes.items()})


def parameter_groups(model: nn.Module) -> Dict[str, List[str]]:
    """Parameter names by the JAX package's ``_is_norm_or_bias_path`` rule,
    read on the torch name: ``norm`` (a name with "norm" or "bn", or a norm
    layer's scale), ``bias`` (the other biases) and ``kernel`` (every other
    weight, embedding and table)."""
    groups: Dict[str, List[str]] = {"kernel": [], "bias": [], "norm": []}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            label = ("norm" if "norm" in name.lower() or "bn" in name.lower()
                     or (isinstance(mod, NORM_TYPES) and p_name == "weight")
                     else "bias" if p_name == "bias" else "kernel")
            groups[label].append(name)
    return groups


def build_optimizer(model: nn.Module, s: SolverConfig) -> torch.optim.Optimizer:
    named = dict(model.named_parameters())
    decay = {"kernel": s.weight_decay, "bias": s.weight_decay_bias,
             "norm": s.weight_decay_norm}
    groups = [{"params": [named[n] for n in names], "weight_decay": decay[label]}
              for label, names in parameter_groups(model).items() if names]
    return torch.optim.AdamW(groups, lr=s.base_lr, betas=tuple(s.betas), eps=1e-8)


def lr_factor(step: int, s: SolverConfig) -> float:
    """WarmupPolyLR's multiple of BASE_LR at update ``step`` (0-based)."""
    if s.warmup_iters <= 0 or step >= s.warmup_iters:
        wf = 1.0
    else:
        alpha = step / s.warmup_iters
        wf = s.warmup_factor * (1 - alpha) + alpha
    frac = min(max(1.0 - step / s.iteration_total, 0.0), 1.0)
    return wf * frac ** s.poly_power


def set_lr(optimizer: torch.optim.Optimizer, step: int, s: SolverConfig) -> None:
    for group in optimizer.param_groups:
        group["lr"] = s.base_lr * lr_factor(step, s)
