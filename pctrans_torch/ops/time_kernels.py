"""Time K1 (ms-deform forward) and K3 (mask render) of two checkouts of the
PyTorch port in turns on one CUDA card.

    python3 -m pctrans_torch.ops.time_kernels OLD_TREE [NEW_TREE]

NEW_TREE defaults to this checkout.  The turns run old, new, new, old, each
in its own process, which imports ``pctrans_torch`` from its tree (building
that tree's kernels into the tree's own ``build/`` at first use) and times
the kernels through the public wrappers ``ms_deform_attn`` and
``dynamic_mask_render`` on ``chip_smoke.py``'s eval-shape inputs, made from
the same seed in every turn: call ms from CUDA events and device ms from
the profiler (``chip_smoke.time_ms`` and ``chip_smoke.device_ms`` of this
checkout).  Prints the card, one line per turn and kernel, and the rel-Fro
between the two trees' outputs; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]


def load_smoke():
    """This checkout's ``chip_smoke.py``, whatever tree is on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def one_turn(tree: Path, out: Path) -> None:
    sys.path[0] = str(tree)          # in place of this file's directory
    import pctrans_torch
    from pctrans_torch.ops.msdeform import ms_deform_attn
    from pctrans_torch.ops.render import dynamic_mask_render

    if not Path(pctrans_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"pctrans_torch came from {pctrans_torch.__file__}, not {tree}")
    smoke = load_smoke()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(smoke.SEED)
    value, shapes, loc, w = smoke.msdeform_inputs(dev, g)
    vb = value.bfloat16()
    render_args = smoke.render_inputs(dev, g)
    calls = {"K1": lambda: ms_deform_attn(vb, shapes, loc, w),
             "K3": lambda: dynamic_mask_render(*render_args)}
    rec = {name: {"ms": smoke.time_ms(fn), "device_ms": smoke.device_ms(fn)}
           for name, fn in calls.items()}
    torch.save({name: fn().float().cpu() for name, fn in calls.items()}, out)
    print(json.dumps(rec))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("old", type=Path)
    parser.add_argument("new", type=Path, nargs="?", default=REPO)
    parser.add_argument("--turn-out", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 1
    if args.turn_out is not None:          # one turn, in its own process
        one_turn(args.old.resolve(), args.turn_out)
        return 0
    smoke = load_smoke()
    print(f"card: {smoke.card_line()}")
    (REPO / "build").mkdir(exist_ok=True)
    outs = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        for i, (label, tree) in enumerate((("old", args.old), ("new", args.new),
                                           ("new", args.new), ("old", args.old))):
            outs[label] = Path(tmp, f"turn{i}.pt")
            res = subprocess.run([sys.executable, __file__, str(tree), "--turn-out",
                                  str(outs[label])], stdout=subprocess.PIPE,
                                 text=True, check=True)
            for name, r in json.loads(res.stdout.splitlines()[-1]).items():
                print(f"{name} {label} ({tree}): {r['ms']:.4f} ms/call, "
                      f"{r['device_ms']:.4f} ms device", flush=True)
        old, new = torch.load(outs["old"]), torch.load(outs["new"])
    for name in old:
        print(f"{name} old vs new output: rel-Fro {smoke.rel_fro(new[name], old[name]):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
