"""Hungarian matching on padded cost matrices (mirror of
``pctrans_tpu/ops/lap.py:260-284``), solved on the host.

The JAX package solves every (image, layer) lane with its own JV solver on
the device; that solver is plain JAX, not a Pallas kernel.  The port copies
all lanes' costs to the host in one transfer and solves each lane's valid
columns with ``scipy.optimize.linear_sum_assignment``, the reference's
solver (an on-device JV kernel is a later item).  Both give the optimal
assignment, so they agree wherever the optimum is unique.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..utils import tracing


def match_padded(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """cost [N, Q, G] (query x ground-truth slot), valid [N, G] bool.

    Returns ``query4gt`` int64 [N, G] on the cost's device: the matched
    query of every valid slot.  Invalid slots get query 0; every consumer
    masks them by ``valid``.
    """
    N, Q, G = cost.shape
    if Q < G:
        raise ValueError(f"match_padded: {Q} queries for {G} slots")
    with tracing.span("wait.lap_costs"):
        cost_h = cost.detach().float().cpu().numpy()
    with tracing.span("wait.lap_valid"):
        valid_h = valid.cpu().numpy()
    out = np.zeros((N, G), np.int64)
    for n in range(N):
        cols = np.flatnonzero(valid_h[n])
        if cols.size:
            # rows = slots, so every valid slot gets a query
            _, q = linear_sum_assignment(cost_h[n][:, cols].T)
            out[n, cols] = q
    return torch.from_numpy(out).to(cost.device)
