"""Checkpoints with the reference's iteration-numbered layout (mirror of
``pctrans_tpu/engine/checkpoint.py``, in ``torch.save`` files).

Each checkpoint is ``<output_dir>/checkpoint_%06d.pth.tar`` (or
``checkpoint_best.pth.tar``) holding ``{iteration, model, optimizer,
lr_scheduler}``: the model's ``state_dict`` (BatchNorm running statistics
included), AdamW's moments and step, and the LR scheduler's position.
``iteration`` counts the optimizer updates done.
"""

from __future__ import annotations

import os
import re
from typing import Callable, List, Optional

import torch
from torch import nn

_FMT = "checkpoint_%06d.pth.tar"
# %06d pads but does not truncate: iteration >= 1e6 writes 7+ digits
_RE = re.compile(r"checkpoint_(\d{6,})\.pth\.tar$")


def save_checkpoint(output_dir: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer],
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler],
                    iteration: int, is_best: bool = False) -> str:
    os.makedirs(output_dir, exist_ok=True)
    name = "checkpoint_best.pth.tar" if is_best else _FMT % iteration
    path = os.path.abspath(os.path.join(output_dir, name))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"iteration": int(iteration), "model": model.state_dict(),
                "optimizer": optimizer.state_dict() if optimizer else None,
                "lr_scheduler": scheduler.state_dict() if scheduler else None}, tmp)
    os.replace(tmp, path)          # a crash never leaves a partial checkpoint
    return path


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, model: nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
                       ) -> int:
    """Strict restore: every model tensor, and the optimizer and scheduler
    when given.  Returns the checkpoint's iteration."""
    data = _load(path)
    model.load_state_dict(data["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(data["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(data["lr_scheduler"])
    return int(data["iteration"])


def restore_partial(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                    log: Callable[[str], None] = print) -> int:
    """Key-filtered, shape-checked restore (a finetune load).

    Every model tensor present in the checkpoint with the same shape is
    loaded; the rest keep their initial values.  The iteration, the
    optimizer and the scheduler are adopted only when every parameter
    matched (otherwise the moments would not line up with the parameters).
    A failed optimizer or scheduler load is logged and leaves both fresh
    (the JAX package swallows it, ``ROADMAP.md`` §C.3).  Returns the
    adopted iteration, 0 when none was.
    """
    data = _load(path)
    saved = data["model"]
    state = model.state_dict()
    params = {n for n, _ in model.named_parameters()}
    loaded, kept, all_params = {}, [], True
    for key, init in state.items():
        src = saved.get(key)
        if src is not None and tuple(src.shape) == tuple(init.shape):
            loaded[key] = src
            continue
        kept.append(key)
        all_params &= key not in params
        if src is not None:
            log(f"[checkpoint] shape mismatch, keeping init: {key} "
                f"{tuple(src.shape)} vs {tuple(init.shape)}")
    model.load_state_dict({**state, **loaded}, strict=True)
    log(f"[checkpoint] partial restore from {path}: {len(loaded)} tensors "
        f"loaded, {len(kept)} kept from init")
    if not all_params:
        log(f"[checkpoint] {path}: not every parameter matched, so its "
            "optimizer state, scheduler and iteration are not adopted (the "
            "moments would not line up)")
        return 0
    fresh = [(m, m.state_dict()) for m in (optimizer, scheduler) if m is not None]
    try:
        if optimizer is not None:
            optimizer.load_state_dict(data["optimizer"])
        if scheduler is not None:
            scheduler.load_state_dict(data["lr_scheduler"])
    except (KeyError, TypeError, ValueError) as e:
        for m, s in fresh:
            m.load_state_dict(s)
        log(f"[checkpoint] optimizer state of {path} does not fit "
            f"({type(e).__name__}: {e}); step and moments start fresh")
        return 0
    return int(data["iteration"])


def list_checkpoints(output_dir: str) -> List[str]:
    """Numbered checkpoints in ``output_dir``, by iteration."""
    if not os.path.isdir(output_dir):
        return []
    found = [f for f in os.listdir(output_dir) if _RE.match(f)]
    return [os.path.join(output_dir, f)
            for f in sorted(found, key=lambda f: int(_RE.match(f).group(1)))]


def latest_checkpoint(output_dir: str) -> Optional[str]:
    cps = list_checkpoints(output_dir)
    return cps[-1] if cps else None


def checkpoint_iteration(path: str) -> int:
    m = _RE.search(os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else -1
