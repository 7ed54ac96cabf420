"""``python3 -m portbench.control``'s readings for a cell whose entry is
``eval_swin``, with its fault ``k6_doubled`` beside the eval faults:

    python3 -m portbench.control_swin --workload NAME --seeds S1 S2 ... \
        [--control-seeds C1 C2 C3] [--faults half altered k6_doubled]

The same lines as ``control.py`` prints (one per reading, then the largest
lower and the smallest upper reading of each number), read with
``entries/eval_swin.py``'s functions in ``entries/eval.py``'s place.  The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import bench, compare, control, faults

FAULTS = ("half", "altered", "k6_doubled")


def readings(run: bench.Run, with_control: bool, fault_names):
    from pctrans_torch.models.transformer_decoder import MultiScaleMaskedTransformerDecoder

    from portbench import traffic as traffic_gen
    from portbench.entries import eval as entry
    from portbench.reference.transformer_decoder import (
        MultiScaleMaskedTransformerDecoder as RefDecoder)

    swin_entry = bench.load_module("entries", "eval_swin")
    cell, device = run.cell, run.device
    batch = int(cell.traffic["batch"])
    scenes = traffic_gen.make_scenes(cell.traffic, run.seed)
    keep = compare.sample(len(scenes) // batch, int(cell.workload["compared_batches"]),
                          run.seed)
    with swin_entry.swapped():
        prog_rec, ref_rec = control.Recorder(), control.Recorder()
        prog_rec.watch(None, MultiScaleMaskedTransformerDecoder, control.layers(cell.config))
        try:
            prog = control.eval_program(run, scenes, keep)
        finally:
            prog_rec.restore()
        ref_rec.watch(None, RefDecoder, control.layers(cell.config))
        try:
            ref = entry.reference_outputs(run, scenes, keep, device)
        finally:
            ref_rec.restore()
        rows = [("program", prog)]
        if with_control:
            rows.append(("control fp8", entry.reference_outputs(run, scenes, keep, device,
                                                                "fp8")))
            for name in fault_names:
                run.fault = (swin_entry.K6Doubled() if name == "k6_doubled"
                             else faults.Fault(name))
                rows.append((f"fault {name}", control.eval_program(run, scenes, keep)))
                run.fault = None
    out = [{"reading": name, **compare.eval_readings(got, ref),
            "detail": compare.eval_details(got, ref)} for name, got in rows]
    out[0]["look"] = control.flips(prog_rec, ref_rec)
    control.free(device)
    for r in out:
        r["seed"] = run.seed
    return out


def summary(workload: str, rows) -> dict:
    """The largest lower (program) and, per other reading, the smallest
    upper reading of each number of ``rows``."""
    numbers = [k for k in rows[0] if k not in ("reading", "seed", "detail", "look")]
    lower = {k: max(r[k] for r in rows if r["reading"] == "program") for k in numbers}
    upper = {}
    for r in rows:
        if r["reading"] != "program":
            u = upper.setdefault(r["reading"], {k: [] for k in numbers})
            for k in numbers:
                u[k].append(r[k])
    return {"workload": workload, "lower": lower,
            "upper": {name: {k: min(v) for k, v in u.items()} for name, u in upper.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control_swin")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=FAULTS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control_swin: no CUDA card", file=sys.stderr)
        return 2
    bench.cache_dirs()
    cell = bench.load_cell(args.workload)
    rows = []
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        run = bench.Run(cell=cell, seed=seed, seconds=0, trace=False)
        for r in readings(run, seed in args.control_seeds, args.faults):
            print(json.dumps(r), flush=True)
            rows.append(r)
    print(json.dumps(summary(cell.name, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
