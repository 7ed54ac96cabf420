"""Eval entry: the evaluator's protocol (``Evaluator.eval_cvppp`` or
``test_bbbc``, by the configuration's ``eval.protocol``) over scenes held in
host memory, in a closed loop: one stream of batches, the next pulled when
the label pipeline asks for it.

Set-up builds the model with the configuration's weights (made on the card
by the reference's initializer from one generator) and its ``Evaluator``,
makes the scenes in the seed's order, and labels ``warmup_batches`` batches
through the same protocol (the TOP_K forward and the full-Q re-run, the
device postprocess, the scoring).  The window pulls batches, cycling
through the scenes, until ``--seconds`` have passed since its first pull,
and ends when the protocol has labelled and scored the last of them.  For a
sample of the first cycle's batches, drawn from the seed, what the timed
path made of them is kept: the first forward's threshold-free outputs
(``compare.snapshot``) and TOP_K peaks, the masks' areas the postprocess
got, the label maps the pipeline gave.  After the window the reference
labels the same images and ``compare.eval_readings`` decides ``correct``.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import bench, compare, probes, timing, trace
from portbench import traffic as traffic_gen


def program_cfg(run: bench.Run):
    from pctrans_torch.config import build_model_config, load_cfg

    from portbench.entries.train import check_sizes

    cfg = load_cfg(*run.cell.yamls(), opts=list(run.cell.config.get("opts", [])))
    check_sizes(build_model_config(cfg), run.cell.config)
    return cfg


def build_evaluator(run: bench.Run, device, probe: probes.Probes):
    from pctrans_torch.config import build_model_config
    from pctrans_torch.engine.evaluator import Evaluator
    from pctrans_torch.models import PCTransModel

    cfg = program_cfg(run)
    model = PCTransModel(build_model_config(cfg))
    model.load_state_dict(compare.seeded_state(run.cell.config, device))
    model.to(device)
    if run.fault is not None:
        run.fault.plant_eval(model, probe)
    ev = run.cell.config["eval"]
    return model, Evaluator(model, int(ev["top_k"]), ev["protocol"])


class Source:
    """The closed loop's stream: batches of ``batch`` scenes in order,
    cycling, until ``seconds`` after the first pull (or ``limit``
    batches); stamps each pull, and ticks the trace window."""

    def __init__(self, scenes, batch: int, seconds: float, limit: int = 0, window=None):
        self.scenes, self.batch = scenes, batch
        self.seconds, self.limit = seconds, limit
        self.window = window
        self.per_cycle = len(scenes) // batch
        self.pulled = []

    def __iter__(self):
        k = 0
        while True:
            now = time.perf_counter()
            if self.limit and k >= self.limit:
                return
            if not self.limit and self.pulled and now - self.pulled[0] >= self.seconds:
                return
            if self.window is not None:
                self.window.tick(k)
            b = traffic_gen.batch_of(self.scenes, k % self.per_cycle, self.batch)
            self.pulled.append(time.perf_counter())
            yield b
            k += 1


class PipelineProbe:
    """The evaluator's label pipeline: per batch the latency from its pull
    to its label maps on the host, and the scoring time (from the pipeline
    yielding it to the protocol asking for the next); keeps the label maps
    of the batches ``keep`` at their first labelling."""

    def __init__(self, evaluator, source: Source, clock: timing.Clock, keep):
        self.orig = evaluator._label_pipeline
        self.source, self.clock = source, clock
        self.keep = set(keep)
        self.labels = {}
        self.latency = []
        evaluator._label_pipeline = self

    def __call__(self, batches):
        k = 0
        for batch, labels in self.orig(batches):
            got = time.perf_counter()
            self.latency.append((got - self.source.pulled[k]) * 1e3)
            if k in self.keep:
                self.labels[k] = labels.copy()
            with record_function("portbench.scoring"):
                yield batch, labels
            self.clock.add("scoring", (time.perf_counter() - got) * 1e3)
            k += 1


class MasksProbe:
    """What the evaluator's forwards made of the batches ``keep`` (each
    batch counted in order by the evaluator's first forward): that
    forward's snapshot (kept on the card until :meth:`outputs`) and TOP_K
    peak logits (from the statistics its lossiness check reads), and the
    areas of the masks the postprocess got (after the re-run, if any)."""

    def __init__(self, model, evaluator, keep):
        from pctrans_torch.inference.device_postprocess import unpack_mask_stats

        self.unpack = unpack_mask_stats
        self.keep = set(keep)
        self.snaps, self.peaks, self.areas = {}, {}, {}
        self.k = {"step": 0, "lossy": 0, "start": 0}
        self.capture = None
        self._step, self._lossy = evaluator._step, evaluator._lossy
        self._start = evaluator.postprocessor.start
        evaluator._step, evaluator._lossy = self.step, self.lossy
        evaluator.postprocessor.start = self.start
        self.hook = model.register_forward_hook(self.forward_hook)

    def _next(self, what: str):
        k = self.k[what]
        self.k[what] += 1
        return k if k in self.keep else None

    def forward_hook(self, module, args, out):
        if self.capture is not None:
            self.snaps[self.capture] = compare.snapshot(out)
            self.capture = None

    def step(self, images):
        self.capture = self._next("step")
        return self._step(images)

    def lossy(self, masks, stats):
        k = self._next("lossy")
        if k is not None:
            self.peaks[k] = np.array(self.unpack(stats)[2], np.float64)
        return self._lossy(masks, stats)

    def start(self, masks, areas, inter):
        k = self._next("start")
        if k is not None:
            self.areas[k] = np.asarray(areas, np.float64).copy()
        return self._start(masks, areas, inter)

    def outputs(self, labels):
        """The kept batches that were labelled, by batch."""
        self.hook.remove()
        return {k: compare.EvalOutput(compare.to_host(self.snaps[k]), self.peaks[k],
                                      self.areas[k], labels[k])
                for k in sorted(self.keep) if k in labels}


def protocol(evaluator, run: bench.Run):
    return (evaluator.test_bbbc if run.cell.config["eval"]["protocol"] == "bbbc"
            else evaluator.eval_cvppp)


def run(run: bench.Run, t0: float) -> None:
    t, w = run.cell.traffic, run.cell.workload
    device = torch.device(run.device)
    batch = int(t["batch"])
    phase = bench.Phases(run)
    scenes = traffic_gen.make_scenes(t, run.seed)
    per_cycle = len(scenes) // batch
    keep = compare.sample(per_cycle, int(w["compared_batches"]), run.seed)
    phase("scenes")
    clock = timing.Clock()
    probe = probes.Probes(clock)
    probe.kernel_ranges()
    try:
        model, evaluator = build_evaluator(run, device, probe)
        probe.postprocess(evaluator.postprocessor)
        score = protocol(evaluator, run)
        phase("model, weights and evaluator")
        score(Source(scenes, batch, 0, limit=int(w["warmup_batches"])))
        phase("warm-up batches")
        window = None
        if run.trace:
            window = trace.Traces(int(w["trace_start"]), int(w["trace_batches"]),
                                  str(bench.BUILD / f"trace_{os.getpid()}.json"), device,
                                  probe, ranges_expected=("portbench.k1", "portbench.k3",
                                                          "portbench.k4"))
        source = Source(scenes, batch, run.seconds, window=window)
        pipe = PipelineProbe(evaluator, source, clock, keep)
        masks = MasksProbe(model, evaluator, keep)
        clock.reset()
        evaluator.forwards = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        run.setup_s = start - t0
        score(source)
        end = time.perf_counter()
        run.window_s = end - start
        if window is not None:
            window.finish(run)
        n_batches = len(pipe.latency)
        run.attempted = len(source.pulled) * batch
        run.failed = (len(source.pulled) - n_batches) * batch
        run.counters.update(batches=n_batches, images=n_batches * batch,
                            forwards=evaluator.forwards)
        if run.trace:
            run.counters["eval_flops_per_forward"] = batch * forward_flops_per_image(run)
        run.end_to_end["eval_img_per_s"] = n_batches * batch / run.window_s
        run.end_to_end["eval_latency_p90_ms"] = timing.quantile(pipe.latency, 0.9)
        run.end_to_end["setup_s"] = run.setup_s
        run.spans = dict(clock.spans)
        if device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        prog = masks.outputs(pipe.labels)
        del model, evaluator, pipe, masks
    finally:
        probe.restore()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.checks = check(run, scenes, keep, prog, device)


def forward_flops_per_image(run: bench.Run) -> float:
    from portbench.counts import flops

    return flops.forward_flops(run.cell.config["model"], tuple(run.cell.traffic["size"]))


def reference_outputs(run: bench.Run, scenes, keep, device, precision="config", fault=None):
    cfg = run.cell.config
    batch = int(run.cell.traffic["batch"])
    model = compare.reference_model(cfg, device, precision)
    return [compare.reference_eval(model, traffic_gen.batch_of(scenes, k, batch)["image"],
                                   int(cfg["eval"]["top_k"]), float(cfg["eval"]["threshold"]),
                                   cfg["eval"]["protocol"], fault) for k in keep]


def check(run: bench.Run, scenes, keep, prog, device):
    """The sampled batches the window labelled against the reference; a
    sampled batch it never labelled is an answer that never came."""
    done = [k for k in keep if k in prog]
    limits = run.cell.workload["limits"]
    readings = (compare.eval_readings([prog[k] for k in done],
                                      reference_outputs(run, scenes, done, device))
                if done else {k: float("inf") for k in limits})
    return ([bench.Check(k, readings[k], float(v)) for k, v in limits.items()]
            + [bench.Check("unlabelled", float(len(keep) - len(done)), 0.0)])
