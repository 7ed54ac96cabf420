"""K6 and the Swin-L model on the card, outside the benchmark's window:

    python3 -m portbench.swin_probe --workload cvppp-swinl.eval --seed N \
        [--parts kernels forward train] [--train-steps 20]

* ``kernels``: K6 and its twin at every stage's windows of the cell's batch
  (plain and shifted) and at a window clamped to a 10x11 map: ms per call
  by CUDA events (20 calls, median of 5), host us to queue one K6 call,
  K6's bound (``counts/swin.py``) and share, and the rel-Fro gap of the two
  bf16 outputs;
* ``forward``: one eval forward of the cell's model and batch, ms by CUDA
  events (median of 20) and host ms to queue it: replayed from CUDA graphs
  with K6 (the cell's path) and with the twin captured in the graphs in
  its place, eager with K6 and eager with the twin in K6's place (every
  other kernel as it is); then one eager forward traced with the
  program's spans on, the device ms inside ``pctrans.model.backbone``,
  ``pixel_decoder`` and ``predictor`` (``program_trace.analyse``);
* ``train``: ``Trainer.train()`` on ``cvppp.train``'s A1 tree and recipe
  (448x448, batch 2, bf16, drop path 0.3 drawn from the step's generator)
  with this configuration's model and weights, for ``--train-steps`` steps:
  host ms per step after the first two, the memory peak, whether every
  loss is finite, and the first step's total loss against the reference's
  on the same batch and draws.

Prints one JSON line per part.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import time

import torch

from . import bench, compare, timing
from . import traffic as traffic_gen

STAGE_MAPS = ((133, 125), (67, 63), (34, 32), (17, 16))


def events_ms(fn, calls: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the CUDA-event ms of ``calls`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call to queue ``fn`` (the card's queue drained
    first, so no call waits on it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def kernels(cell, device) -> dict:
    from pctrans_torch.ops.window_attn import window_attention

    from .counts.swin import window_attn_work

    m = cell.config["model"]
    batch, window = int(cell.traffic["batch"]), int(m["swin_window_size"])
    shapes = [(f"res{i + 2}", hw, m["swin_embed_dim"] * 2 ** i, m["swin_num_heads"][i])
              for i, hw in enumerate(STAGE_MAPS)]
    shapes.append(("clamped", (10, 11), m["swin_embed_dim"], m["swin_num_heads"][0]))
    rows = {}
    g = torch.Generator(device=device).manual_seed(0)
    for name, hw, C, H in shapes:
        for shifted in (False, True):
            ws = window if min(hw) > window else min(hw)
            shift = window // 2 if shifted and min(hw) > window else 0
            if shifted and not shift:
                continue
            grid = (math.ceil(hw[0] / ws), math.ceil(hw[1] / ws))
            qkv = torch.randn(batch * grid[0] * grid[1], ws * ws, 3 * C, generator=g,
                              device=device).bfloat16()
            table = torch.randn((2 * window - 1) ** 2, H, generator=g, device=device)
            args = (qkv, table, H, ws, window, shift, grid, (C // H) ** -0.5)
            with torch.inference_mode():
                got = window_attention(*args)
                twin = window_attention(*args, impl="twin")
                k6_ms = events_ms(lambda: window_attention(*args))
                twin_ms = events_ms(lambda: window_attention(*args, impl="twin"))
                host = host_us(lambda: window_attention(*args))
            n_bytes, flops = window_attn_work(args, got)
            bound, by = timing.bound_ms(n_bytes, flops, timing.PEAK_BF16_FLOP_PER_S)
            rows[f"{name}.shift{shift}"] = {
                "windows": qkv.shape[0], "tokens": ws * ws, "channels": C, "heads": H,
                "k6_ms": k6_ms, "twin_ms": twin_ms, "bound_ms": bound, "by": by,
                "share_pct": 100.0 * bound / k6_ms, "rel_fro": compare.rel_fro(got, twin),
                "k6_host_us": host}
    return {"part": "kernels", "rows": rows}


def model_and_batch(cell, seed, device):
    from pctrans_torch.config import build_model_config
    from pctrans_torch.models import PCTransModel

    from .entries import eval as eval_entry
    from .reference.model_swin import swin_model

    model = PCTransModel(build_model_config(eval_entry.program_cfg(bench.Run(
        cell=cell, seed=seed, seconds=0, trace=False))))
    model.load_state_dict(swin_model(cell.config, device).state_dict())
    scenes = traffic_gen.make_scenes(cell.traffic, seed)
    images = traffic_gen.batch_of(scenes, 0, int(cell.traffic["batch"]))["image"]
    return model.to(device).eval(), torch.from_numpy(images).to(device)


def forward(cell, seed, device) -> dict:
    import pctrans_torch.models.swin as swin
    from pctrans_torch.models import graphs
    from pctrans_torch.ops.window_attn import window_attention
    from pctrans_torch.utils import tracing

    from . import program_trace

    model, x = model_and_batch(cell, seed, device)

    def twin_attention(*args, **kwargs):
        return window_attention(*args, impl="twin")

    def timed(fn):
        host = []

        def call():
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
        ms = events_ms(call, calls=1, repeats=20)
        return {"ms": ms, "host_ms": 1e3 * statistics.median(host)}

    out = {"part": "forward"}
    with torch.inference_mode():
        model(x)                                   # the capture
        out["replay"] = timed(lambda: model(x))
        graphs._GRAPHS.pop(model, None)
        attention = [m for m in model.modules() if isinstance(m, swin.WindowAttention)]
        for m in attention:                        # the twin, inside the graphs
            m.kernel = False
        try:
            model(x)
            out["replay_twin"] = timed(lambda: model(x))
        finally:
            for m in attention:
                m.kernel = True
            graphs._GRAPHS.pop(model, None)
        hook = model.backbone.register_forward_hook(lambda *a: None)     # eager
        try:
            out["eager_k6"] = timed(lambda: model(x))
            swin.window_attention = twin_attention
            try:
                out["eager_twin"] = timed(lambda: model(x))
            finally:
                swin.window_attention = window_attention
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            tracing.enable()
            try:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    model(x)
                    torch.cuda.synchronize()
            finally:
                tracing.disable()
                tracing.reset()
        finally:
            hook.remove()
    path = bench.BUILD / "swin_probe_trace.json"
    bench.BUILD.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        ranges = program_trace.analyse(json.load(f)["traceEvents"])["program_ranges"]
    path.unlink()
    out["device_ms"] = {name: 1e3 * ranges[f"model.{name}"]["device_s"]
                        for name in ("backbone", "pixel_decoder", "predictor")
                        if f"model.{name}" in ranges}
    return out


def reference_first_loss(config, batch, device) -> float:
    """The reference's first train step's total loss on ``batch``: the
    criterion's draws, then the backbone's drop path, from one generator
    seeded as the program's (the program's train step draws in this
    order)."""
    from .reference import criterion as ref_criterion
    from .reference.model_swin import swin_model
    from .reference.targets import targets_from_labels

    with compare.no_tf32():
        model = swin_model(config, device)
        model.train()
        crit = ref_criterion.SetCriterion(ref_criterion.CriterionConfig(**config["criterion"]))
        gen = torch.Generator(device=device).manual_seed(int(config["train"]["draw_seed"]))
        images = torch.as_tensor(batch["image"]).to(device).float()
        labels = torch.as_tensor(batch["label"]).to(device).int()
        targets = targets_from_labels(labels, int(config["train"]["max_instances"]))
        reid, drawn = crit.draws(images.shape[0], int(config["train"]["max_instances"]),
                                 model.config.num_queries, gen, device)
        out = model(images, generator=gen)
        total, _, _ = crit(out, targets, reid, drawn or None)
        return float(total.detach())


def train(config, seed, steps, device) -> dict:
    from .entries import train as train_entry
    from .probes import Probes
    from .reference.model_swin import swin_model

    cell = bench.load_cell("cvppp.train")
    cell = dataclasses.replace(cell, config=config)
    run = bench.Run(cell=cell, seed=seed, seconds=0, trace=False)
    tree = train_entry.write_tree(run)
    cfg = train_entry.program_cfg(run, tree, str(bench.BUILD / "out" / "cvppp-swinl.train"))
    seeded = compare.seeded_state
    compare.seeded_state = lambda c, d: swin_model(c, d).state_dict()
    try:
        trainer = train_entry.build_trainer(run, cfg, device)
    finally:
        compare.seeded_state = seeded
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    step = train_entry.compared_steps(run, trainer, Probes(timing.Clock()), steps, steps)
    train_entry.sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    first = trainer.train_loader.kept[0]
    ms = [1e3 * (b - a) for a, b in zip(step.stamps[2:], step.stamps[3:])]
    losses = list(step.losses)
    del trainer, step
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_first_loss(config, first, device)
    return {"part": "train", "steps": steps, "host_ms_per_step": statistics.median(ms),
            "memory_peak_bytes": peak, "losses_finite": all(map(math.isfinite, losses)),
            "losses": losses, "first_loss": losses[0], "reference_first_loss": ref,
            "first_loss_gap": abs(losses[0] - ref) / abs(ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.swin_probe")
    p.add_argument("--workload", default="cvppp-swinl.eval")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--parts", nargs="+", default=["kernels", "forward", "train"],
                   choices=("kernels", "forward", "train"))
    p.add_argument("--train-steps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.swin_probe: no CUDA card", file=sys.stderr)
        return 2
    bench.cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = bench.load_cell(args.workload)
    head = {"device": torch.cuda.get_device_name(0)}
    for part in args.parts:
        if part == "kernels":
            line = kernels(cell, device)
        elif part == "forward":
            line = forward(cell, args.seed, device)
        else:
            line = train(cell.config, args.seed, args.train_steps, device)
        print(json.dumps({**head, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
