"""Train entry: ``Trainer.train()`` on the recipe, fed by the program's own
loader from an A1 tree on disk written from the seed.

Set-up builds one ``Trainer`` (model, AdamW, WarmupPolyLR, monitor,
loader), gives it the configuration's weights, and drives it through a
warm-up ``train()`` call of ``warmup_steps`` steps.  Its first
``compared_steps`` steps are the ones the reference follows: their batches
(as the loader gave them), losses, first gradient (AdamW's first moment
after one step), first forward's threshold-free outputs and the parameters
after them are kept.  The rate of its later steps sizes the window: one
more ``train()`` call of the same Trainer lasting about ``--seconds`` (its
loader and monitor reopened: ``train()`` closes both).  After the window, with the Trainer
freed, the reference runs the compared steps and
``compare.train_readings`` decides ``correct``.
"""

from __future__ import annotations

import gc
import math
import os
import time

import torch
from torch.profiler import record_function

from portbench import bench, compare, probes, timing, trace
from portbench.compare import host_copy
from portbench import traffic as traffic_gen


def program_cfg(run: bench.Run, tree: str, out: str, extra=()):
    from pctrans_torch.config import build_model_config, load_cfg
    from pctrans_torch.engine.solver import build_solver_config
    from pctrans_torch.losses.criterion import build_criterion_config

    cell = run.cell
    opts = list(cell.config.get("opts", [])) + [
        "DATASET.DATA_TYPE", "CVPPP", "DATASET.INPUT_PATH", tree,
        "DATASET.OUTPUT_PATH", out, "INFERENCE.OUTPUT_PATH", os.path.join(out, "test")
    ] + list(extra)
    cfg = load_cfg(*cell.yamls(), opts=opts)
    check_sizes(build_model_config(cfg), cell.config)
    check_fields(build_criterion_config(cfg), cell.config["criterion"], "criterion")
    check_fields(build_solver_config(cfg), cell.config["solver"], "solver")
    # the criterion's draws: the Trainer seeds them from SYSTEM.SEED, 42 unless set
    if int(cfg.SYSTEM.get("SEED", 42)) != int(cell.config["train"]["draw_seed"]):
        raise ValueError("the program draws from another seed than the configuration "
                         "file states")
    for key, want in (("SOLVER.SAMPLES_PER_BATCH", cell.config["train"]["batch"]),
                      ("MODEL.MAX_INSTANCES", cell.config["train"]["max_instances"]),
                      ("MODEL.INPUT_SIZE", cell.config["train"]["input_size"])):
        node, leaf = key.split(".")
        if cfg[node][leaf] != want:
            raise ValueError(f"the program reads {key}={cfg[node][leaf]!r}, the "
                             f"configuration file states {want!r}")
    return cfg


def check_fields(program_obj, stated: dict, what: str) -> None:
    """The program must read from the recipe what the configuration file
    states (and the reference reads)."""
    for key, want in stated.items():
        got = getattr(program_obj, key)
        if (tuple(got) if isinstance(got, (list, tuple)) else got) != (
                tuple(want) if isinstance(want, list) else want):
            raise ValueError(f"the program reads {what} {key}={got!r} from the recipe, "
                             f"the configuration file states {want!r}")


def check_sizes(program_config, config: dict) -> None:
    check_fields(program_config, config["model"], "model")


def write_tree(run: bench.Run) -> str:
    return traffic_gen.a1_tree(run.cell.traffic, run.seed,
                               str(bench.BUILD / "data" / run.cell.workload["traffic"]))


class StepProbe:
    """The Trainer's train step, counted and stamped; keeps what the
    reference compares from the first ``compared`` steps, and ticks the
    trace window."""

    def __init__(self, trainer, compared: int, window=None):
        self.trainer = trainer
        self.step = trainer._train_step
        self.compared = compared
        self.window = window
        self.i = 0
        self.stamps = []
        self.losses = []
        self.terms = []
        self.grads = {}
        self.params = {}
        self.snap = {}

    def __call__(self, batch, *args, **kwargs):
        i = self.i
        self.i += 1
        if self.window is not None:
            self.window.tick(i)
        self.stamps.append(time.perf_counter())
        hook = (self.trainer.model.register_forward_hook(self.keep_snapshot)
                if i == 0 and self.compared else None)
        with record_function("portbench.train_step"):
            metrics = self.step(batch, *args, **kwargs)
        if hook is not None:
            hook.remove()
        if i < self.compared:
            self.losses.append(float(metrics["loss"]))
            self.terms.append({k: float(v) for k, v in metrics.items() if k != "loss"})
            if i == 0:
                self.grads = first_gradient(self.trainer.model, self.trainer.optimizer)
            if i == self.compared - 1:
                self.params = {n: host_copy(p)
                               for n, p in self.trainer.model.named_parameters()}
        return metrics


    def keep_snapshot(self, module, args, out):
        if not self.snap:
            self.snap = compare.to_host(compare.snapshot(out))


def first_gradient(model, optimizer):
    """The gradient the optimizer got at its first step, from its state:
    AdamW's first moment is (1 - beta1) g after one step."""
    out = {}
    for group in optimizer.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "exp_avg" in state:
                out[p] = host_copy(state["exp_avg"]) / (1.0 - beta1)
    return {n: out[p] for n, p in model.named_parameters() if p in out}


def build_trainer(run: bench.Run, cfg, device):
    """The Trainer with the seed's weights (made on the device by the
    reference's initializer from one generator)."""
    from pctrans_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, mode="train", device=device)
    trainer.model.load_state_dict(compare.seeded_state(run.cell.config, device))
    return trainer


def compared_steps(run: bench.Run, trainer, probe: probes.Probes, compared: int,
                   warmup: int) -> StepProbe:
    """The warm-up ``train()`` call; returns its step probe."""
    trainer.train_loader = probes.LoaderProbe(trainer.train_loader, probe.clock,
                                              keep=compared)
    step = StepProbe(trainer, compared)
    trainer._train_step = step
    if run.fault is not None:
        run.fault.plant_train(trainer, probe)
    trainer.start_iter, trainer.total_iters = 0, warmup
    trainer.train()
    return step


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reopen(trainer, cfg, clock: timing.Clock) -> None:
    """The loader and monitor a finished ``train()`` call closed, built
    again as ``Trainer.__init__`` builds them."""
    from pctrans_torch.data.build import build_dataloader
    from pctrans_torch.utils.monitor import build_monitor

    trainer._train_data = build_dataloader(cfg, "train", process_index=trainer.rank,
                                           process_count=trainer.world)
    trainer.train_loader = probes.LoaderProbe(iter(trainer._train_data), clock)
    if trainer.is_main:
        trainer.monitor = build_monitor(cfg)


def timed_call(trainer, first: int, n: int, window=None) -> StepProbe:
    """One ``train()`` call of iterations ``first .. first + n - 1``."""
    step = StepProbe(trainer, 0, window)
    trainer._train_step = step
    trainer.start_iter, trainer.total_iters = first, first + n
    trainer.train()
    return step


def run(run: bench.Run, t0: float) -> None:
    cell, w = run.cell, run.cell.workload
    device = torch.device(run.device)
    compared, warmup = int(w["compared_steps"]), int(w["warmup_steps"])
    if warmup < compared + 2:
        raise ValueError(f"{cell.name}: warmup_steps {warmup} leaves no two steps "
                         f"after the {compared} compared ones to time")
    batch = int(run.cell.config["train"]["batch"])
    out = str(bench.BUILD / "out" / cell.name)
    phase = bench.Phases(run)
    tree = write_tree(run)
    phase("A1 tree")
    cfg = program_cfg(run, tree, out)
    clock = timing.Clock()
    probe = probes.Probes(clock)
    probe.kernel_ranges()
    probe.matcher()
    try:
        trainer = build_trainer(run, cfg, device)
        phase("Trainer and weights")
        step = compared_steps(run, trainer, probe, compared, warmup)
        kept = trainer.train_loader.kept
        prog = compare.TrainOutput(step.losses, step.grads, step.params, step.snap,
                                   step.terms)
        # the warm steps after the compared ones size the window
        per_iter = (step.stamps[-1] - step.stamps[compared]) / (warmup - 1 - compared)
        n = max(1, math.ceil(run.seconds / per_iter))
        phase("warm-up train() call")

        # the window: one more train() call of the same Trainer
        reopen(trainer, cfg, clock)
        window = None
        if run.trace:
            window = trace.Traces(n // 3, int(w["trace_steps"]),
                                  str(bench.BUILD / f"trace_{os.getpid()}.json"), device,
                                  probe, ranges_expected=("portbench.k1", "portbench.k2"))
        clock.reset()
        sync(device)
        start = time.perf_counter()
        run.setup_s = start - t0
        step = timed_call(trainer, warmup, n, window)
        end = time.perf_counter()
        run.window_s = end - start
        if window is not None:
            window.finish(run)
        run.attempted = n
        run.counters["iterations"] = n
        run.counters["images"] = n * batch * trainer.world
        run.end_to_end["train_img_per_s"] = n * batch * trainer.world / run.window_s
        run.end_to_end["setup_s"] = run.setup_s
        run.spans = dict(clock.spans)
        if run.trace:
            run.counters["train_flops_per_image"] = train_flops_per_image(run)
        if device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        trainer.train_loader = None
        del trainer, step
    finally:
        probe.restore()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.checks = check(run, kept, prog, device)


def train_flops_per_image(run: bench.Run) -> float:
    from portbench.counts import flops

    cfg = run.cell.config
    return 3 * flops.forward_flops(cfg["model"], tuple(cfg["train"]["input_size"]))


def check(run: bench.Run, batches, prog: compare.TrainOutput, device):
    ref = compare.reference_train(run.cell.config, batches, device)
    readings = compare.train_readings(prog, ref)
    limits = run.cell.workload["limits"]
    return [bench.Check(k, readings[k], float(v)) for k, v in limits.items()]
