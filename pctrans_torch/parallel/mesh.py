"""Multi-card training with one process per card (counterpart of
``pctrans_tpu/parallel/mesh.py``).

The JAX package runs one jitted program over a batch-sharded mesh, which
gives *global-batch* semantics: BatchNorm statistics, the criterion's
normalisers and the gradient are those of the whole global batch.  Here
each card runs its own process with its rows of the global batch, and the
same semantics come from collectives:

* :func:`initialize_distributed` joins the process group from the env://
  variables that ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` for the card);
* :func:`all_reduce_sum` is autograd-aware (SyncBN's statistics), and
  :func:`global_sum` a plain sum for counts (the criterion's denominators);
* :func:`rank_rows` slices this rank's rows out of a draw made for the
  global batch, so every random draw of a train step is the global one;
* :func:`average_gradients` averages the gradients after ``backward``.

Without an initialised group of more than one process every helper is the
identity, so one process is exactly the single-card path.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def resolve_backend(name: Optional[str], device: torch.device) -> str:
    """``SYSTEM.DISTRIBUTED_BACKEND``: the default ``"ici"`` means NCCL on a
    CUDA device and gloo on the CPU; ``nccl`` and ``gloo`` as written."""
    name = (name or "ici").lower()
    if name == "ici":
        return "nccl" if device.type == "cuda" else "gloo"
    if name not in ("nccl", "gloo"):
        raise ValueError(f"SYSTEM.DISTRIBUTED_BACKEND {name!r}: one of ici, nccl, gloo")
    return name


def initialize_distributed(backend: Optional[str] = None, device="cuda",
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group that ``torchrun`` (or any env:// launcher)
    describes and return this rank's device: ``cuda:LOCAL_RANK``, or the
    CPU for ``device="cpu"``.  A missing variable, a card that does not
    exist or a failed rendezvous raises: nothing falls back to independent
    single-process trainers writing the same output directory."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs the env:// variables {', '.join(missing)}; launch with "
            "torchrun --nproc_per_node=N scripts/main_torch.py --distributed ...")
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {os.environ['RANK']}: LOCAL_RANK {local} names no card "
                               f"({torch.cuda.device_count()} visible)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(resolve_backend(backend, dev), init_method="env://",
                                timeout=timeout)
    return dev


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, with the gradient flowing back through it (the
    backward sums the ranks' output gradients)."""
    if not is_distributed():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


@torch.no_grad()
def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a count, without gradient."""
    if not is_distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def rank_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous share of ``t``'s ``dim``, a draw made for the
    global batch (rank-major, as the global batch stacks the ranks' rows)."""
    w = world_size()
    if w == 1:
        return t
    n = t.shape[dim] // w
    return t.narrow(dim, rank() * n, n)


def check_equal_across_ranks(value: int, what: str) -> None:
    """Raise on every rank when ``value`` differs between ranks: a mean over
    a rank's own rows is the global mean only when every rank holds as many
    rows."""
    if not is_distributed():
        return
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([value, -value], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise ValueError(f"{what} differs between ranks ({lo} to {hi}); the global "
                         "batch must split evenly")


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Every gradient becomes its mean over the ranks, in one flat
    all-reduce.  A parameter that no rank's loss reached keeps no gradient
    (as on one card, where the optimizer then skips it); one reached on some
    ranks only takes zeros on the others."""
    if not is_distributed():
        return
    params = [p for p in params if p.requires_grad]
    dev = params[0].device
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.int32, device=dev)
    dist.all_reduce(has)
    reached = [p for p, h in zip(params, has.tolist()) if h]
    if not reached:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      .float() for p in reached])
    dist.all_reduce(flat)
    flat /= world_size()
    offset = 0
    for p in reached:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n


def barrier(timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """All ranks wait here (the others while rank 0 validates or writes).
    gloo's monitored barrier takes the timeout itself; NCCL's watchdog
    enforces the process group's."""
    if not is_distributed():
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=timeout)
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])


def destroy() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
