"""The readings a cell's correctness limits are set from, at the cell's
own sizes, without a measured window:

    python3 -m portbench.control --workload NAME --seeds S1 S2 ... \
        [--control-seeds C1 C2 C3] [--faults half altered unchanged]

* for each ``--seeds`` seed, the program's numbers (its output against the
  reference's on what its timed path consumed: a train cell's compared
  steps, an eval cell's sampled batches): the lower readings;
* for each ``--control-seeds`` seed, the control's numbers (the reference
  computed in float8 e4m3, put in the program's place, against the
  reference) and each ``--faults`` fault's (planted in the reference put
  in the program's place for a train cell, in the program for an eval
  cell): the upper readings.

One JSON line per reading, then the largest lower and the smallest upper
reading of each number.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, List

import torch

from . import bench, compare, faults, probes, timing
from .reference import matcher as ref_matcher
from .reference.transformer_decoder import MultiScaleMaskedTransformerDecoder as RefDecoder


class Recorder:
    """The look at why two sound computations part: records what
    ``match_padded`` assigned (train) and which attention-mask bits the
    decoder's layers set in the first forward, on the program and on the
    reference, for :func:`flips`."""

    def __init__(self):
        self.matches, self.masks = [], []
        self._undo = []

    def patch(self, owner, attr, make):
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def restore(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def watch(self, matcher_module, decoder_class, layers: int):
        def matches(fn):
            def recorded(cost, valid):
                out = fn(cost, valid)
                self.matches.append((out.cpu(), valid.cpu()))
                return out
            return recorded

        def masks(fn):
            def recorded(*args, **kwargs):
                out = fn(*args, **kwargs)
                if len(self.masks) < layers:
                    self.masks.append((out[1] < 0).cpu())
                return out
            return recorded
        if matcher_module is not None:
            self.patch(matcher_module, "match_padded", matches)
        self.patch(decoder_class, "dynamic_mask_with_coords", masks)


def flips(prog: Recorder, ref: Recorder) -> dict:
    """Attention-mask bits that differ, per decoder layer of the first
    forward (share of the bits); Hungarian assignments that differ, per
    matching call (count of valid slots)."""
    out = {"mask_bits": [round(float((a != b).float().mean()), 6)
                         for a, b in zip(prog.masks, ref.masks)]}
    if prog.matches:
        out["assignments"] = [int(((a != b) & v).sum()) for (a, v), (b, _) in
                              zip(prog.matches, ref.matches)]
    return out


def layers(cell_config: dict) -> int:
    """Mask predictions per forward: the learnable queries' and one per
    decoder layer."""
    return int(cell_config["model"]["dec_layers"]) + 1


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def train_program(run: bench.Run):
    """The program's compared steps (the warm-up call's first steps, as a
    run drives them); returns (their batches, its output)."""
    from portbench.entries import train as entry

    device = torch.device(run.device)
    compared = int(run.cell.workload["compared_steps"])
    tree = entry.write_tree(run)
    cfg = entry.program_cfg(run, tree, str(bench.BUILD / "out" / run.cell.name))
    probe = probes.Probes(timing.Clock())
    rec = Recorder()
    try:
        import pctrans_torch.losses.matcher as matcher
        from pctrans_torch.models.transformer_decoder import MultiScaleMaskedTransformerDecoder

        trainer = entry.build_trainer(run, cfg, device)
        rec.watch(matcher, MultiScaleMaskedTransformerDecoder, layers(run.cell.config))
        step = entry.compared_steps(run, trainer, probe, compared, compared)
        batches = trainer.train_loader.kept
        prog = compare.TrainOutput(step.losses, step.grads, step.params, step.snap,
                                   step.terms)
        del trainer, step
    finally:
        probe.restore()
        rec.restore()
    free(device)
    return batches, prog, rec


def eval_program(run: bench.Run, scenes, keep):
    """The program's labelling of the sampled batches through the
    protocol (a stream of just those batches)."""
    from portbench.entries import eval as entry

    device = torch.device(run.device)
    batch = int(run.cell.traffic["batch"])
    picked = [scenes[i] for k in keep for i in range(k * batch, (k + 1) * batch)]
    probe = probes.Probes(timing.Clock())
    try:
        model, evaluator = entry.build_evaluator(run, device, probe)
        source = entry.Source(picked, batch, 0, limit=len(keep))
        pipe = entry.PipelineProbe(evaluator, source, timing.Clock(), range(len(keep)))
        masks = entry.MasksProbe(model, evaluator, range(len(keep)))
        entry.protocol(evaluator, run)(source)
        out = list(masks.outputs(pipe.labels).values())
        del model, evaluator, pipe, masks
    finally:
        probe.restore()
    free(device)
    return out


def readings(run: bench.Run, control: bool, fault_names: List[str]) -> List[Dict]:
    """The program's numbers against the reference, with the look at why
    they part; with ``control``, the control's and each fault's numbers."""
    device = run.device
    cell = run.cell
    if cell.workload["entry"] == "train":
        batches, prog, prog_rec = train_program(run)
        ref_rec = Recorder()
        ref_rec.watch(ref_matcher, RefDecoder, layers(cell.config))
        try:
            ref = compare.reference_train(cell.config, batches, device)
        finally:
            ref_rec.restore()
        out = [{"reading": "program", **compare.train_readings(prog, ref, detail=True),
                "look": flips(prog_rec, ref_rec)}]
        if control:
            ctrl = compare.reference_train(cell.config, batches, device, "fp8")
            out.append({"reading": "control fp8",
                        **compare.train_readings(ctrl, ref, detail=True)})
            for name in fault_names:
                broken = compare.reference_train(cell.config, batches, device,
                                                 fault=faults.Fault(name))
                out.append({"reading": f"fault {name}",
                            **compare.train_readings(broken, ref, detail=True)})
    else:
        from pctrans_torch.models.transformer_decoder import MultiScaleMaskedTransformerDecoder

        from portbench import traffic as traffic_gen
        from portbench.entries import eval as entry

        batch = int(cell.traffic["batch"])
        scenes = traffic_gen.make_scenes(cell.traffic, run.seed)
        keep = compare.sample(len(scenes) // batch, int(cell.workload["compared_batches"]),
                              run.seed)
        prog_rec, ref_rec = Recorder(), Recorder()
        prog_rec.watch(None, MultiScaleMaskedTransformerDecoder, layers(cell.config))
        try:
            prog = eval_program(run, scenes, keep)
        finally:
            prog_rec.restore()
        ref_rec.watch(None, RefDecoder, layers(cell.config))
        try:
            ref = entry.reference_outputs(run, scenes, keep, device)
        finally:
            ref_rec.restore()
        rows = [("program", prog)]
        if control:
            rows.append(("control fp8", entry.reference_outputs(run, scenes, keep, device,
                                                                "fp8")))
            for name in fault_names:
                run.fault = faults.Fault(name)
                rows.append((f"fault {name}", eval_program(run, scenes, keep)))
                run.fault = None
        out = [{"reading": name, **compare.eval_readings(got, ref),
                "detail": compare.eval_details(got, ref)} for name, got in rows]
        out[0]["look"] = flips(prog_rec, ref_rec)
    free(device)
    for r in out:
        r["seed"] = run.seed
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=faults.FAULTS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench.cache_dirs()
    cell = bench.load_cell(args.workload)
    rows = []
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        run = bench.Run(cell=cell, seed=seed, seconds=0, trace=False)
        for r in readings(run, seed in args.control_seeds, args.faults):
            print(json.dumps(r), flush=True)
            rows.append(r)
    numbers = [k for k in rows[0] if k not in ("reading", "seed", "detail", "look")]
    lower = {k: max(r[k] for r in rows if r["reading"] == "program") for k in numbers}
    upper = {}
    for r in rows:
        if r["reading"] != "program":
            u = upper.setdefault(r["reading"], {k: [] for k in numbers})
            for k in numbers:
                u[k].append(r[k])
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": {name: {k: min(v) for k, v in u.items()}
                                for name, u in upper.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
