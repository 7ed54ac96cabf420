"""What the harness installs around the program's calls: host-clock spans
and ``record_function`` ranges, kept in memory (``timing.Clock``).

* ``portbench.k1`` .. ``portbench.k4``: a range around each call of the
  hand-written kernels' wrappers as the model and the eval step call them
  (``ms_deform_attn`` in ``models/pixel_decoder.py``,
  ``ms_deform_attn_backward`` in ``ops/msdeform.py``,
  ``dynamic_mask_render`` in ``models/transformer_decoder.py``,
  ``resize_bilinear_binarize`` in ``engine/eval_step.py``); while a trace
  window is open, each call's bytes and operations (``timing``) are summed
  on the device, so that the roofline share holds whatever kernels a later
  change launches inside the range.
* ``loader_wait``: ``next()`` on the Trainer's train loader
  (:class:`LoaderProbe`, which forwards ``close()``).
* ``matcher``: ``match_padded`` as ``losses/matcher.py`` imported it (the
  cost matrix's copy to the host, which waits for the forward, and
  scipy's LAP).
* ``postprocess``: ``DevicePostprocessor.start`` and ``finish`` on the
  evaluator's instance.

Every patch is undone by :meth:`Probes.restore`.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from . import timing

# range -> (the peak its operations are counted against, the unit's
# products per operation counted): K3 is f32-accurate on the tensor cores
# by three TF32 products each (3xTF32), as chip_smoke.py bounds it
RANGE_UNITS = {"portbench.k1": (timing.PEAK_F32_FLOP_PER_S, 1),
               "portbench.k2": (timing.PEAK_F32_FLOP_PER_S, 1),
               "portbench.k3": (timing.PEAK_TF32_FLOP_PER_S, 3),
               "portbench.k4": (timing.PEAK_F32_FLOP_PER_S, 1)}


class Probes:
    def __init__(self, clock: timing.Clock):
        self.clock = clock
        self.counting = False          # sum kernel work (while a trace window is open)
        self.work: Dict[str, list] = {}
        self._undo: List[tuple] = []

    # ------------------------------------------------------------ patching
    def patch(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def restore(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def span(self, name: str):
        """A decorator factory: ``fn`` timed as span ``name`` inside a range."""
        def make(fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with record_function(f"portbench.{name}"):
                    t0 = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        self.clock.add(name, (time.perf_counter() - t0) * 1e3)
            return wrapped
        return make

    def _kernel(self, name: str, work):
        """A decorator factory: ``fn`` inside range ``name``; while counting,
        ``work(args, out)`` -> (bytes, FLOP) is summed for that range."""
        def make(fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with record_function(name):
                    out = fn(*args, **kwargs)
                if self.counting:
                    with torch.no_grad():
                        n_bytes, flops = work(args, out)
                    acc = self.work.setdefault(name, [0, 0, 0])
                    acc[0] += n_bytes
                    acc[1] = acc[1] + flops
                    acc[2] += 1
                return out
            return wrapped
        return make

    def kernel_ranges(self) -> None:
        import pctrans_torch.engine.eval_step as eval_step
        import pctrans_torch.models.pixel_decoder as pixel_decoder
        import pctrans_torch.models.transformer_decoder as transformer_decoder
        import pctrans_torch.ops.msdeform as msdeform

        self.patch(pixel_decoder, "ms_deform_attn", self._kernel(
            "portbench.k1", lambda a, out: timing.msdeform_work(a[0], a[1], a[2], a[3])))
        self.patch(msdeform, "ms_deform_attn_backward", self._kernel(
            "portbench.k2",
            lambda a, out: timing.msdeform_backward_work(a[0], a[1], a[2], a[3], a[4])))
        self.patch(transformer_decoder, "dynamic_mask_render", self._kernel(
            "portbench.k3", lambda a, out: timing.render_work(*a[:9], out)))
        self.patch(eval_step, "resize_bilinear_binarize", self._kernel(
            "portbench.k4", lambda a, out: timing.resize_binarize_work(a[0], out)))

    def matcher(self) -> None:
        import pctrans_torch.losses.matcher as matcher

        self.patch(matcher, "match_padded", self.span("matcher"))

    def postprocess(self, postprocessor) -> None:
        for attr in ("start", "finish"):
            self.patch(postprocessor, attr, self.span("postprocess"))

    def kernel_bounds(self) -> Dict[str, dict]:
        """Per range: the summed bound (ms) of the calls counted, by the
        larger of bytes and operations (each counted operation as many
        products as its unit runs); and the calls."""
        out = {}
        for name, (n_bytes, flops, calls) in self.work.items():
            flops = float(flops)
            rate, products = RANGE_UNITS[name]
            ms, by = timing.bound_ms(n_bytes, products * flops, rate)
            out[name] = {"bound_s": ms / 1e3, "by": by, "calls": calls,
                         "bytes": n_bytes, "flops": flops}
        return out


class LoaderProbe:
    """The Trainer's train loader, each ``next()`` timed as ``loader_wait``;
    the first ``keep`` batches are kept (copies) for the reference."""

    def __init__(self, it, clock: timing.Clock, keep: int = 0):
        self.it = it
        self.clock = clock
        self.keep = keep
        self.kept: List[dict] = []

    def __iter__(self):
        return self

    def __next__(self):
        with record_function("portbench.loader_wait"):
            t0 = time.perf_counter()
            batch = next(self.it)
            self.clock.add("loader_wait", (time.perf_counter() - t0) * 1e3)
        if len(self.kept) < self.keep:
            self.kept.append({k: v.copy() for k, v in batch.items()
                              if k in ("image", "label")})
        return batch

    def close(self) -> None:
        self.it.close()
