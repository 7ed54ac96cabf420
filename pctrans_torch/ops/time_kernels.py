"""Time K1 (ms-deform forward), K2 (ms-deform backward), K3 (mask render),
K4 (upsample+binarize) and K5 (separable ms-deform forward) of two
checkouts of the PyTorch port in turns on one CUDA card.

    python3 -m pctrans_torch.ops.time_kernels OLD_TREE [NEW_TREE]

NEW_TREE defaults to this checkout.  The turns run old, new, new, old, each
in its own process, which imports ``pctrans_torch`` from its tree (building
that tree's kernels into the tree's own ``build/`` at first use) and times
the kernels through the public wrappers on ``chip_smoke.py``'s inputs, made
from the same seed in every turn: K1, K5 and K3 at the eval shapes (K1 and
K5 on the bf16 value), K2 alone (``ms_deform_attn_backward``) on the K2
gate's train-shape inputs and on its contention case, K4 at [4, 50, 133,
125] and [4, 100, 133, 125] -> 530x500.  Call ms from CUDA events, device
ms from the profiler (``chip_smoke.time_ms`` and ``chip_smoke.device_ms``
of this checkout; for K5 its own kernel's events), and for K2 also the
kernel's own device ms.  Prints the card, one line per turn and kernel,
then old against new: the rel-Fro of K1's, K5's and K3's outputs and of
K2's d_value, d_loc and d_w, K5's separable twin's beside K5's (the twin
rounds hat_x as the kernel does since the bf16 repair), and K4's
differing bytes with the largest distance of their f32 logits from the
threshold.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
LOGIT_T = math.log(0.69 / 0.31)     # the recipe's mask threshold as a logit


def load_smoke():
    """This checkout's ``chip_smoke.py``, whatever tree is on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def one_turn(tree: Path, out: Path) -> None:
    sys.path[0] = str(tree)          # in place of this file's directory
    import pctrans_torch
    from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_backward,
                                            ms_deform_attn_separable,
                                            ms_deform_attn_separable_twin)
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    if not Path(pctrans_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"pctrans_torch came from {pctrans_torch.__file__}, not {tree}")
    smoke = load_smoke()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(smoke.SEED)
    value, shapes, loc, w = smoke.msdeform_inputs(dev, g)
    vb = value.bfloat16()
    render_args = smoke.render_inputs(dev, g)
    v2, shapes2, loc2, w2, gout2 = smoke.msdeform_backward_inputs(dev, g)
    v2, gout2 = v2.bfloat16(), gout2.bfloat16()
    loc_c = smoke.contention_locations(loc2, shapes2, g)
    xs = {K: smoke.resize_inputs(dev, g, K) for K in (50, 100)}
    t = LOGIT_T
    calls = {"K1": lambda: ms_deform_attn(vb, shapes, loc, w),
             "K2": lambda: ms_deform_attn_backward(v2, shapes2, loc2, w2, gout2),
             "K2 contention": lambda: ms_deform_attn_backward(v2, shapes2, loc_c, w2, gout2),
             "K3": lambda: dynamic_mask_render(*render_args),
             "K4 K=50": lambda: resize_bilinear_binarize(xs[50], smoke.IMAGE_HW, t),
             "K4 K=100": lambda: resize_bilinear_binarize(xs[100], smoke.IMAGE_HW, t),
             "K5": lambda: ms_deform_attn_separable(vb, shapes, loc, w)}
    dev_kw = {"K5": {"kernel": smoke.K5_KERNEL, "launches": 1}}
    rec = {name: {"ms": smoke.time_ms(fn),
                  "device_ms": smoke.device_ms(fn, **dev_kw.get(name, {}))}
           for name, fn in calls.items()}
    for name in ("K2", "K2 contention"):
        rec[name]["kernel_device_ms"] = smoke.device_ms(calls[name], kernel="msdeform_bwd_kernel")
    outs = {}
    for name, fn in calls.items():
        res = fn()
        outs[name] = [r.cpu() for r in (res if isinstance(res, tuple) else (res,))]
    outs["K4 inputs"] = {K: x.cpu() for K, x in xs.items()}
    outs["K5 twin"] = [ms_deform_attn_separable_twin(vb, shapes, loc, w).cpu()]
    torch.save(outs, out)
    print(json.dumps(rec))


def compare(old: dict, new: dict, image_hw) -> None:
    """Old against new outputs of the same inputs."""
    from pctrans_torch.ops.resize import resize_bilinear

    smoke = load_smoke()
    for name in ("K1", "K2", "K2 contention", "K3", "K5", "K5 twin"):
        errs = " ".join(f"{smoke.rel_fro(b.float(), a.float()):.3e}"
                        for a, b in zip(old[name], new[name]))
        what = "d_value, d_loc, d_w" if name.startswith("K2") else "output"
        print(f"{name} old vs new {what}: rel-Fro {errs}")
    for K, x in new["K4 inputs"].items():
        a, b = old[f"K4 K={K}"][0], new[f"K4 K={K}"][0]
        differ = a != b
        n = int(differ.sum())
        far = 0.0
        if n:
            logits = resize_bilinear(x.cuda(), image_hw).cpu()
            far = float((logits[differ] - LOGIT_T).abs().max())
        print(f"K4 K={K} old vs new: {n} of {a.numel()} bytes differ"
              + (f", all within {far:.3e} of the threshold in the f32 logits" if n else ""))


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
                kernel = (f" (the kernel {r['kernel_device_ms']:.4f})"
                          if "kernel_device_ms" in r else "")
                print(f"{name} {label} ({tree}): {r['ms']:.4f} ms/call, "
                      f"{r['device_ms']:.4f} ms device{kernel}", flush=True)
        compare(torch.load(outs["old"]), torch.load(outs["new"]), smoke.IMAGE_HW)
    return 0


if __name__ == "__main__":
    sys.exit(main())
