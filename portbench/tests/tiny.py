"""A tiny cell for the CPU tests: the recipe's configuration with the
port's tiny test sizes (ResNet-14, hidden 32, 10 queries, 64x64 crops)
and a traffic of a few small scenes or plants, run on the CPU, where the
program's wrappers take their kernels' plain twins."""

from __future__ import annotations

import copy
import dataclasses
import time

from portbench import bench

TINY_OPTS = ["MODEL.RESNETS.DEPTH", "14", "MODEL.MASK_FORMER.HIDDEN_DIM", "32",
             "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.SEM_SEG_HEAD.MASK_DIM", "8",
             "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "10", "MODEL.MASK_FORMER.NHEADS", "4",
             "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
             "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
             "MODEL.MASK_FORMER.DEC_LAYERS", "4", "MODEL.SEM_SEG_HEAD.NORM", "GN",
             "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256", "MODEL.MAX_INSTANCES", "8",
             "MODEL.INPUT_SIZE", "[64, 64]", "INFERENCE.TOP_K", "4",
             "MONITOR.TENSORBOARD", "False", "SYSTEM.NUM_CPUS", "2"]
# eval at the smallest sizes gives masks that are all or nothing; these give
# masks of many sizes and label maps with instances
EVAL_OPTS = ["MODEL.SEM_SEG_HEAD.NORM", "SyncBN", "MODEL.SEM_SEG_HEAD.MASK_DIM", "16",
             "MODEL.MASK_FORMER.HIDDEN_DIM", "64", "MODEL.SEM_SEG_HEAD.CONVS_DIM", "64"]


def tiny_config(name: str, opts=TINY_OPTS) -> dict:
    """The configuration file ``name`` cut to the tiny sizes, its model,
    criterion, solver and train keys read back from the program's
    configuration as the real files were written."""
    from pctrans_torch.config import build_model_config, load_cfg
    from pctrans_torch.losses.criterion import build_criterion_config

    config = copy.deepcopy(bench.read_json(bench.HERE / "configs" / f"{name}.json"))
    config["opts"] = list(opts)
    cfg = load_cfg(*[str(bench.REPO / p) for p in config["yaml"]], opts=list(opts))
    mc, cc = build_model_config(cfg), build_criterion_config(cfg)

    def plain(v):
        return list(v) if isinstance(v, tuple) else v
    config["model"] = {k: plain(getattr(mc, k)) for k in config["model"]}
    config["criterion"] = {k: plain(getattr(cc, k)) for k in config["criterion"]}
    config["train"].update(input_size=[64, 64], max_instances=8)
    config["eval"]["top_k"] = 4
    return config


def tiny_cell(name: str) -> bench.Cell:
    """Cell ``name`` of BENCHMARK.json at the tiny sizes."""
    cell = bench.load_cell(name)
    train = cell.traffic["kind"] == "a1_tree"
    opts = TINY_OPTS if train else TINY_OPTS + EVAL_OPTS
    cell = dataclasses.replace(cell, config=tiny_config(cell.workload["config"], opts),
                               traffic=dict(cell.traffic), workload=dict(cell.workload))
    t = cell.traffic
    if train:
        t.update(plants=6, size=[80, 72], threads=2)
        cell.workload.update(warmup_steps=5, trace_steps=2)
    else:
        t.update(count=8, size=[96, 96] if t["size"][0] < 525 else [96, 128])
        cell.workload.update(trace_start=1, trace_batches=2)
    return cell


def tiny_run(name: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
             fault=None) -> bench.Run:
    cell = tiny_cell(name)
    run = bench.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                    fault=fault)
    bench.load_module("entries", cell.workload["entry"]).run(run, time.perf_counter())
    return run
