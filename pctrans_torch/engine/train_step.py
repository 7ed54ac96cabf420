"""Train step (mirror of ``pctrans_tpu/engine/state.py:52-114``).

``make_train_step(model, criterion, optimizer, scheduler, max_instances,
generator)(batch)`` runs one optimizer step on
``{"image": [B, H, W, 3], "label": [B, H, W]}`` (numpy or tensors):

  1. widen the image to f32 and build the padded targets on the device;
  2. forward in train mode (bf16 autocast when the config asks for it; BN
     layers normalise with the batch statistics and update their running
     ones);
  3. match without grad, then the loss dict and its weighted total in f32;
  4. backward (K1's autograd Function runs K2 on the card), one AdamW step
     and one scheduler step.

Returns the total (``"loss"``) and every raw loss as detached 0-d tensors.
The uniform draws of the re-id negatives come from ``generator`` unless the
caller passes ``reid_uniform`` [B, max_instances, Q].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..data.targets import targets_from_labels
from ..losses.criterion import SetCriterion
from ..models import PCTransModel


def make_train_step(model: PCTransModel, criterion: SetCriterion,
                    optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    max_instances: int,
                    generator: Optional[torch.Generator] = None) -> Callable:
    device = next(model.parameters()).device
    num_queries = model.config.num_queries

    def train_step(batch: Dict, reid_uniform: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        images = torch.as_tensor(batch["image"]).to(device).float()
        labels = torch.as_tensor(batch["label"]).to(device).int()
        targets = targets_from_labels(labels, max_instances)
        if reid_uniform is None:
            reid_uniform = torch.rand((images.shape[0], max_instances, num_queries),
                                      generator=generator, device=device)
        optimizer.zero_grad(set_to_none=True)
        outputs = model(images)
        total, losses, _ = criterion(outputs, targets, reid_uniform.to(device))
        total.backward()
        optimizer.step()
        scheduler.step()
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    return train_step
