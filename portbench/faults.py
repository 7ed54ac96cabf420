"""Faults planted under the timed path, for the tests that show the
comparison catches them and for the readings a limit is set from.

Train:

* ``unchanged``: the optimizer step returns the state unchanged;
* ``half``: half of the batch left out where the loss is taken: the
  forward sees the whole batch, the criterion only its first half, so the
  loss's means run over the rest;
* ``altered``: an answer altered where it is produced: the deformable
  sampling (K1 on the card, its twin on the CPU) returns its output
  doubled.

Eval:

* ``half``: half of the batch left out: the second half's images reach the
  model as zeros;
* ``altered``: an answer altered where it is produced: the dynamic mask
  render (K3 on the card, its twin on the CPU) returns its logits doubled.

``plant_train`` / ``plant_eval`` break the program; ``unchanged``,
``images`` and ``in_reference`` break the reference put in its place.
"""

from __future__ import annotations

import contextlib
import functools

import torch

FAULTS = ("unchanged", "half", "altered")


def _doubled(fn):
    def doubled(*args, **kwargs):
        return 2.0 * fn(*args, **kwargs)
    return doubled


def _first_rows(x, batch: int, n: int):
    """``x`` (a tensor, or a dict, list or tuple of them) with every
    tensor of ``batch`` rows cut to its first ``n``."""
    if torch.is_tensor(x):
        return x[:n] if x.dim() and x.shape[0] == batch else x
    if isinstance(x, dict):
        return {k: _first_rows(v, batch, n) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_first_rows(v, batch, n) for v in x)
    return x


def _half_criterion(call):
    """A criterion's ``__call__`` that takes the loss over the first half
    of the batch: the outputs, targets and draws cut to it."""
    def half(crit, outputs, targets, reid_uniform, *args, **kwargs):
        batch = reid_uniform.shape[0]
        n = max(1, batch // 2)
        cut = functools.partial(_first_rows, batch=batch, n=n)
        return call(crit, cut(outputs), cut(targets), cut(reid_uniform),
                    *[cut(a) for a in args], **{k: cut(v) for k, v in kwargs.items()})
    return half


class Fault:
    def __init__(self, name: str):
        if name not in FAULTS:
            raise ValueError(f"fault {name!r}: one of {FAULTS}")
        self.name = name

    @property
    def unchanged(self) -> bool:
        return self.name == "unchanged"

    def images(self, images: torch.Tensor) -> torch.Tensor:
        """Eval images, the second half zeroed."""
        if self.name != "half":
            return images
        out = images.clone()
        out[max(1, len(out) // 2):] = 0
        return out

    # --------------------------------------------------- in the program
    def plant_train(self, trainer, probes) -> None:
        """Break the Trainer (its step wrapped by ``entries/train.py``'s
        probe); module patches go through ``probes`` (undone with it)."""
        if self.name == "unchanged":
            trainer.optimizer.step = lambda *a, **k: None
        elif self.name == "half":
            from pctrans_torch.losses.criterion import SetCriterion

            probes.patch(SetCriterion, "__call__", _half_criterion)
        else:
            import pctrans_torch.models.pixel_decoder as pixel_decoder

            probes.patch(pixel_decoder, "ms_deform_attn", _doubled)

    def plant_eval(self, model, probes) -> None:
        if self.name == "half":
            forward = model.forward

            def half_forward(images, *args, **kwargs):
                return forward(self.images(images), *args, **kwargs)
            model.forward = half_forward
        elif self.name == "altered":
            import pctrans_torch.models.transformer_decoder as transformer_decoder

            probes.patch(transformer_decoder, "dynamic_mask_render", _doubled)

    # ------------------------------------------------- in the reference
    @contextlib.contextmanager
    def in_reference(self, train: bool):
        """The fault in the reference: ``altered``, its deformable sampling
        (``train``) or its render (eval) returns a doubled output;
        ``half`` in training, its criterion takes the first half."""
        from .reference import criterion, pixel_decoder, transformer_decoder

        if self.name == "altered":
            owner, attr = ((pixel_decoder, "ms_deform_attn") if train
                           else (transformer_decoder, "dynamic_mask_render"))
            make = _doubled
        elif self.name == "half" and train:
            owner, attr, make = criterion.SetCriterion, "__call__", _half_criterion
        else:
            yield
            return
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        try:
            yield
        finally:
            setattr(owner, attr, orig)
