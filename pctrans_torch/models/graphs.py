"""The eval forward replayed as CUDA graphs, in segments that break at the
hand-written kernels.

The eval forward of :class:`~.pctrans.PCTransModel` makes ~3,000 small
launches, and the host queueing them one at a time keeps the card idle
most of each batch.  Where the forward can see that a replay gives the
eager answer -- a CUDA input, the model in eval mode under
``inference_mode``, no ``ops._build.twins()`` scope, no ``generator`` and
no autocast region around the call (:func:`why_eager`), and no hook or
``forward`` of its own on a submodule -- :func:`run` serves it from CUDA
graphs:

* The forward is captured in segments that end at each call of a
  hand-written kernel: ``ms_deform_attn`` (K1), ``dynamic_mask_render``
  (K3) and, in a Swin backbone, ``window_attention`` (K6), which the model
  calls through :func:`hand_kernel`.  A replay calls each of them eagerly
  between its segments, looked up by its module attribute at that moment,
  so whatever wraps the attribute (a profiler range, a count of work, a
  planted fault) wraps every replayed call, and its ``.launches`` counter
  counts it; the output is copied into the slot the next segment was
  captured to read.
* The first call of an input shape and dtype runs the forward eagerly on a
  side stream, which gives that call's answer, and then captures it there,
  with autocast's weight-cast cache off so that no cast made in the
  capture outlives it.  Later calls copy their images into the static
  input and replay.  At most :data:`MAX_SHAPES` shapes keep graphs, the
  least recently used going first.
* The graphs of one shape share one memory pool and replay in the order
  they were captured.  A replay hands out clones of the static outputs: the
  next replay overwrites the static memory, while the label pipeline holds
  a batch's outputs across the next batch's forward.
* Graphs read the storages they were captured on: every call reads the
  data pointers of every parameter and buffer and the identity of every
  submodule, and captures again after any change.  An in-place
  ``load_state_dict`` keeps the graphs, and they replay the new weights.

Counters ``graph_captures`` and ``graph_replays`` (``utils/tracing.py``)
count the captures and the forwards a replay served.  One forward is
recorded or captured at a time, from one thread.
"""

from __future__ import annotations

import gc
import sys
import weakref
from collections import OrderedDict
from typing import Any, Callable, List, Optional

import torch
from torch import nn

from ..ops import _build
from ..utils import tracing

MAX_SHAPES = 4

# while a forward is recorded or captured: what hand_kernel calls through
_tape: Optional[Callable] = None


def hand_kernel(module: str, name: str, *args, **kwargs):
    """``module.name(*args, **kwargs)``, the function looked up now: a
    hand-written kernel's call site in the model.  While :func:`run`
    records or captures a forward, the call goes through its tape."""
    fn = getattr(sys.modules[module], name)
    if _tape is None:
        return fn(*args, **kwargs)
    return _tape(module, name, fn, args, kwargs)


def why_eager(model: nn.Module, images: torch.Tensor,
              generator: Optional[torch.Generator]) -> Optional[str]:
    """Why ``model(images, generator)`` runs eagerly; None where
    :func:`run` serves it."""
    if model.training:
        return "train mode"
    if not torch.is_inference_mode_enabled():
        return "not under inference_mode"
    if _build.in_twins():
        return "inside _build.twins()"
    if generator is not None:
        return "a generator"
    if images.device.type != "cuda":
        return f"a {images.device.type} input"
    if _tape is not None or torch.cuda.is_current_stream_capturing():
        return "inside a capture"
    if torch.is_autocast_enabled():
        return "inside an autocast region"
    return None


def _map(fn, x):
    """``x`` (a tensor, or a dict, list or tuple of them) with ``fn``
    applied to every tensor."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    return x


def _parts(model: nn.Module) -> List[tuple]:
    """What :func:`_observe` reads, per module: (the submodule, or None for
    ``model`` itself, whose hooks ``Module.__call__`` runs; its children,
    parameters and buffers).  Holds no reference to ``model``, which keys
    the graphs weakly."""
    return [(None if mod is model else mod, mod._modules, mod._parameters, mod._buffers)
            for mod in model.modules()]


def _observe(parts: List[tuple]):
    """(the identity of every child and the data pointers of every
    parameter and buffer of ``parts``, whether a submodule has a forward
    hook or a ``forward`` of its own)."""
    m = nn.modules.module
    hooked = bool(m._global_forward_hooks or m._global_forward_pre_hooks)
    state: List[int] = []
    for mod, children, params, buffers in parts:
        if mod is not None and (mod._forward_hooks or mod._forward_pre_hooks
                                or "forward" in mod.__dict__):
            hooked = True
        state.extend(map(id, children.values()))
        state.extend(t.data_ptr() for t in params.values() if t is not None)
        state.extend(t.data_ptr() for t in buffers.values() if t is not None)
    return tuple(state), hooked


def _abandon(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture that an error broke off, whatever state it left."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass


class Segments:
    """One input shape's graphs: ``graphs[i]`` runs up to the i-th
    hand-kernel call ``calls[i]`` = (module, attribute, args, kwargs),
    whose output goes into ``slots[i]``; the last graph ends the forward
    in ``outputs``."""

    def __init__(self, static_in, graphs, calls, slots, outputs):
        self.static_in, self.graphs, self.calls = static_in, graphs, calls
        self.slots, self.outputs = slots, outputs

    @classmethod
    def capture(cls, forward: Callable, images: torch.Tensor,
                stream: torch.cuda.Stream):
        """Runs ``forward(images)`` eagerly on ``stream`` and captures it
        there.  Returns (the segments, the eager outputs)."""
        dev = images.device
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        metas = []

        def record(module, name, fn, args, kwargs):
            out = fn(*args, **kwargs)
            metas.append((out.shape, out.stride(), out.dtype))
            return out

        with torch.cuda.stream(stream):
            answer = _taped(record, forward, images)
        # outside the pool: the static input and each kernel's output slot
        static_in = torch.empty(images.shape, dtype=images.dtype, device=dev)
        slots = [torch.empty_strided(size, stride, dtype=dtype, device=dev)
                 for size, stride, dtype in metas]
        torch.cuda.synchronize(dev)
        gc.collect()
        pool = torch.cuda.graph_pool_handle()
        graphs: List[torch.cuda.CUDAGraph] = []
        calls: List[tuple] = []

        def begin():
            graphs.append(torch.cuda.CUDAGraph())
            graphs[-1].capture_begin(pool=pool, capture_error_mode="thread_local")

        def cut(module, name, fn, args, kwargs):
            if len(calls) == len(slots):
                raise RuntimeError("the captured forward calls more hand-written "
                                   "kernels than the eager one")
            graphs[-1].capture_end()
            calls.append((module, name, args, kwargs))
            begin()
            return slots[len(calls) - 1]

        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        try:
            with torch.cuda.stream(stream):
                begin()
                try:
                    outputs = _taped(cut, forward, static_in)
                except BaseException:
                    _abandon(graphs[-1])
                    raise
                graphs[-1].capture_end()
        finally:
            torch.set_autocast_cache_enabled(cache)
        if len(calls) != len(slots):
            raise RuntimeError(f"the captured forward calls {len(calls)} hand-written "
                               f"kernels, the eager one {len(slots)}")
        current.wait_stream(stream)
        _map(lambda t: t.record_stream(current), answer)
        return cls(static_in, graphs, calls, slots, outputs), answer

    def replay(self, images: torch.Tensor) -> Any:
        self.static_in.copy_(images)
        for graph, (module, name, args, kwargs), slot in zip(self.graphs, self.calls,
                                                              self.slots):
            graph.replay()
            slot.copy_(getattr(sys.modules[module], name)(*args, **kwargs))
        self.graphs[-1].replay()
        return _map(torch.clone, self.outputs)


def _taped(tape: Callable, forward: Callable, images: torch.Tensor):
    global _tape
    _tape = tape
    try:
        return forward(images)
    finally:
        _tape = None


class ModelGraphs:
    """One model's segments by input shape, dtype and device, least
    recently used first, and the state they were captured on."""

    def __init__(self):
        self.parts: List[tuple] = []
        self.state: Optional[tuple] = None
        self.shapes: "OrderedDict[tuple, Segments]" = OrderedDict()
        self.streams = {}

    def retire(self, key=None) -> None:
        """Drops the segments of ``key`` (all by default) once the card has
        run every replay queued."""
        keys = list(self.shapes) if key is None else [key]
        for dev in {k[2] for k in keys}:
            torch.cuda.synchronize(dev)
        for k in keys:
            del self.shapes[k]

    def __call__(self, model: nn.Module, images: torch.Tensor, forward: Callable):
        state, hooked = _observe(self.parts)
        if state != self.state:
            self.retire()
            self.parts = _parts(model)
            state, hooked = _observe(self.parts)
            self.state = state
        if hooked:
            return forward(images)
        key = (tuple(images.shape), images.dtype, images.device)
        segments = self.shapes.get(key)
        if segments is None:
            if len(self.shapes) >= MAX_SHAPES:
                self.retire(next(iter(self.shapes)))
            stream = self.streams.get(images.device)
            if stream is None:
                stream = self.streams[images.device] = torch.cuda.Stream(images.device)
            self.shapes[key], answer = Segments.capture(forward, images, stream)
            tracing.count("graph_captures")
            return answer
        self.shapes.move_to_end(key)
        tracing.count("graph_replays")
        with tracing.span("model.replay"):
            return segments.replay(images)


_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, ModelGraphs]" = weakref.WeakKeyDictionary()


def run(model: nn.Module, images: torch.Tensor, forward: Callable) -> Any:
    """``forward(images)``, the model's eager eval forward, served from its
    graphs (captured in this call on a new shape); eagerly where a
    submodule has a hook or a ``forward`` of its own."""
    g = _GRAPHS.get(model)
    if g is None:
        g = _GRAPHS[model] = ModelGraphs()
    return g(model, images, forward)
