"""Stochastic weight averaging (mirror of ``pctrans_tpu/engine/swa.py`` and
the SWA checkpoint's BatchNorm refresh, ``pctrans_tpu/engine/trainer.py:
335-354``).

``SWAState`` keeps the running mean of the model's f32 parameters, merged
from ``SWA.START_ITER`` every ``SWA.MERGE_ITER`` updates;
``refresh_batch_stats`` re-estimates the BatchNorm running statistics under
the averaged weights with train-mode forwards, each one the flax
momentum-0.9 update of the port's ``layers.BatchNorm`` (not
``torch.optim.swa_utils.update_bn``, which resets the statistics and takes
a cumulative mean).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch
from torch import nn

from ..models.layers import BatchNorm


class SWAState:
    """The averaged parameters (name -> f32 tensor) and how many merged."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None, count: int = 0):
        self.params = params
        self.count = count

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor]) -> "SWAState":
        """Merge ``params``: ``(avg * n + p) / (n + 1)``, elementwise in f32
        in the JAX package's order."""
        if self.params is None:
            return SWAState({k: v.detach().clone() for k, v in params.items()}, 1)
        n = self.count
        avg = {k: (a * n + params[k].detach()) / (n + 1) for k, a in self.params.items()}
        return SWAState(avg, n + 1)


def maybe_update_swa(swa: SWAState, params: Dict[str, torch.Tensor], iteration: int,
                     start_iter: int, merge_iter: int) -> SWAState:
    """Merge after update ``iteration`` (1-based) from ``start_iter`` on,
    every ``merge_iter``."""
    if iteration >= start_iter and iteration % max(merge_iter, 1) == 0:
        return swa.update(params)
    return swa


def has_batch_norm(model: nn.Module) -> bool:
    return any(isinstance(m, BatchNorm) for m in model.modules())


@torch.no_grad()
def refresh_batch_stats(model: nn.Module, batches: Iterator[Dict], n_iter: int) -> None:
    """``max(n_iter, 1)`` train-mode forwards of ``batches``' images (f32,
    as the loader gives them): each updates the running statistics in
    place.  The model is left in train mode."""
    device = next(model.parameters()).device
    model.train()
    for _ in range(max(int(n_iter), 1)):
        model(torch.as_tensor(next(batches)["image"]).to(device).float())
