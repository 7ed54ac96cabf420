"""Train step (mirror of ``pctrans_tpu/engine/state.py:52-114``).

``make_train_step(model, criterion, optimizer, scheduler, max_instances,
generator)(batch)`` runs one optimizer step on
``{"image": [B, H, W, 3], "label": [B, H, W]}`` (numpy or tensors):

  1. widen the image to f32 (a uint8 image, ``DATASET.TRANSFER_UINT8``, is
     dequantized as ``u8 * (hi - lo) / 255 + lo`` over ``input_range``) and
     build the padded targets on the device;
  2. forward in train mode (bf16 autocast when the config asks for it; BN
     layers normalise with the batch statistics and update their running
     ones);
  3. match without grad, then the loss dict and its weighted total in f32;
  4. backward (K1's autograd Function runs K2 on the card), the gradient
     clipping of ``solver``, one optimizer step, the plateau scale fed the
     total loss (ReduceLROnPlateau only: a host read of the loss), one
     scheduler step.

Returns the total (``"loss"``) and every raw loss as detached 0-d tensors.
The criterion's uniform draws (:meth:`SetCriterion.draws`) come from
``generator`` unless the caller passes ``reid_uniform`` [B, max_instances,
Q] and, in a point mode, ``point_draws``; a Swin backbone's drop path draws
from ``generator`` after them.

Across ranks (``parallel.mesh``, one process per card) the step has the
global batch's semantics, as the JAX step over a batch-sharded mesh: every
draw is made for the global batch (``B`` times the world size; the draws a
caller passes are the global batch's too) and sliced to this rank's rows,
SyncBN and the criterion's normalisers are global, the gradients are
averaged over the ranks after ``backward`` (before clipping), and the
returned losses are the global batch's (their mean over the ranks).  Every
rank must hold as many images.  A model with the DETR predictor is refused:
it gives masks only, and the criterion needs the PCTrans predictor's
reference points (JAX fails there at ``losses/criterion.py:391``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..data.targets import targets_from_labels
from ..losses.criterion import SetCriterion
from ..models import PCTransModel
from ..parallel import mesh
from .solver import SolverConfig, clip_gradients


def widen_images(images: torch.Tensor, input_range: Tuple[float, float]) -> torch.Tensor:
    """f32 images; uint8 ones dequantized as ``u8 * ((hi - lo) / 255) + lo``
    with f32 constants (``pctrans_tpu/engine/state.py:80-82``) and one
    rounding, as XLA's fused multiply-add gives it: the f64 product and sum
    are exact."""
    if images.dtype != torch.uint8:
        return images.float()
    lo, hi = float(input_range[0]), float(input_range[1])
    scale = float(torch.tensor((hi - lo) / 255.0, dtype=torch.float32))
    offset = float(torch.tensor(lo, dtype=torch.float32))
    return (images.double() * scale + offset).float()


def make_train_step(model: PCTransModel, criterion: SetCriterion,
                    optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    max_instances: int,
                    generator: Optional[torch.Generator] = None,
                    solver: Optional[SolverConfig] = None,
                    input_range: Tuple[float, float] = (0.0, 1.0)) -> Callable:
    if model.config.transformer_decoder_name != "MultiScaleMaskedTransformerDecoder":
        raise ValueError(
            f"training with {model.config.transformer_decoder_name}: the PCTrans "
            "criterion needs the reference points and query embeddings that only "
            "MultiScaleMaskedTransformerDecoder gives")
    device = next(model.parameters()).device
    num_queries = model.config.num_queries
    dense = criterion.cfg.point_select == "dense"

    def train_step(batch: Dict, reid_uniform: Optional[torch.Tensor] = None,
                   point_draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        images = widen_images(torch.as_tensor(batch["image"]).to(device), input_range)
        labels = torch.as_tensor(batch["label"]).to(device).int()
        targets = targets_from_labels(labels, max_instances)
        world = mesh.world_size()
        mesh.check_equal_across_ranks(images.shape[0], "the per-rank batch")
        if reid_uniform is None or (point_draws is None and not dense):
            reid, drawn = criterion.draws(images.shape[0] * world, max_instances,
                                          num_queries, generator, device)
            reid_uniform = reid if reid_uniform is None else reid_uniform
            point_draws = drawn if point_draws is None else point_draws
        reid_uniform, point_draws = criterion.rank_draws(
            reid_uniform.to(device), {k: v.to(device) for k, v in (point_draws or {}).items()})
        optimizer.zero_grad(set_to_none=True)
        outputs = model(images, generator=generator)
        total, losses, _ = criterion(outputs, targets, reid_uniform, point_draws or None)
        total.backward()
        mesh.average_gradients(model.parameters())
        if solver is not None:
            clip_gradients(model.parameters(), solver)
        optimizer.step()
        metrics = {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
        if world > 1:
            stacked = mesh.global_sum(torch.stack(list(metrics.values())).float()) / world
            metrics = dict(zip(metrics, stacked.unbind()))
        if getattr(scheduler, "plateau", False):
            scheduler.observe(float(metrics["loss"]))
        scheduler.step()
        return metrics

    return train_step
