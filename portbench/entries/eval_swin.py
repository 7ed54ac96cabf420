"""Eval entry of a configuration with a Swin backbone: ``entries/eval.py``'s
closed loop, set-up, window and check, run with what differs for Swin:

* the weights and the reference are ``reference/model_swin.py``'s (the
  Swin backbone under the recipe's pixel decoder and decoder);
* ``portbench.k6``: a range around each call of K6, Swin's fused window
  attention (``window_attention`` as ``models/swin.py`` calls it through
  ``graphs.hand_kernel``), its work counted by ``counts/swin.py`` against
  the bf16 tensor-core peak, for ``eval.k6_roofline``;
* the forward's FLOPs from ``counts/swin.py``, for ``eval.mfu_pct``.

``eval.py``'s functions that differ are swapped for these while the run
lasts (:func:`swapped`), and the trace's kernel ranges and their units
gain ``portbench.k6``.  A program without K6 fails at the import below.
"""

from __future__ import annotations

import contextlib

import torch

import pctrans_torch.models.swin as swin
from pctrans_torch.ops.window_attn import window_attention  # noqa: F401  (K6, or fail at once)

from portbench import bench, compare, faults, probes, timing, trace
from portbench import traffic as traffic_gen
from portbench.counts import swin as swin_counts
from portbench.entries import eval as base
from portbench.reference.model_swin import swin_model

K6 = "portbench.k6"


def build_evaluator(run: bench.Run, device, probe: probes.Probes):
    from pctrans_torch.config import build_model_config
    from pctrans_torch.engine.evaluator import Evaluator
    from pctrans_torch.models import PCTransModel

    cfg = base.program_cfg(run)
    model = PCTransModel(build_model_config(cfg))
    model.load_state_dict(swin_model(run.cell.config, device).state_dict())
    model.to(device)
    probe.patch(swin, "window_attention", probe._kernel(K6, swin_counts.window_attn_work))
    if run.fault is not None:
        run.fault.plant_eval(model, probe)
    ev = run.cell.config["eval"]
    return model, Evaluator(model, int(ev["top_k"]), ev["protocol"])


def forward_flops_per_image(run: bench.Run) -> float:
    return swin_counts.forward_flops(run.cell.config["model"], tuple(run.cell.traffic["size"]))


def reference_outputs(run: bench.Run, scenes, keep, device, precision="config", fault=None):
    cfg = run.cell.config
    batch = int(run.cell.traffic["batch"])
    model = swin_model(cfg, device, precision)
    return [compare.reference_eval(model, traffic_gen.batch_of(scenes, k, batch)["image"],
                                   int(cfg["eval"]["top_k"]), float(cfg["eval"]["threshold"]),
                                   cfg["eval"]["protocol"], fault) for k in keep]


class K6Doubled:
    """The fault ``k6_doubled``: K6 (its twin on the CPU) returns its output
    doubled, in every block."""
    name = "k6_doubled"

    def images(self, images: torch.Tensor) -> torch.Tensor:
        return images

    def plant_eval(self, model, probe: probes.Probes) -> None:
        probe.patch(swin, "window_attention", faults._doubled)


@contextlib.contextmanager
def swapped():
    """``eval.py`` with this module's functions in place of its own, and
    ``portbench.k6`` among the trace's kernel ranges, until the end."""
    names = ("build_evaluator", "forward_flops_per_image", "reference_outputs")
    saved = {n: getattr(base, n) for n in names}
    kernel_ranges = trace.KERNEL_RANGES
    for n in names:
        setattr(base, n, globals()[n])
    trace.KERNEL_RANGES = kernel_ranges + (K6,)
    probes.RANGE_UNITS[K6] = (timing.PEAK_BF16_FLOP_PER_S, 1)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(base, n, fn)
        trace.KERNEL_RANGES = kernel_ranges
        probes.RANGE_UNITS.pop(K6, None)


def run(run: bench.Run, t0: float) -> None:
    with swapped():
        base.run(run, t0)
