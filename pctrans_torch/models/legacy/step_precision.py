"""How far one f32 train step of a legacy model lies from the same step in
f64, on the CPU and on the card:

    python3 -m pctrans_torch.models.legacy.step_precision deeplabv3a deeplabv3c \
        --batch 2 3 [--aux-out] [--size 256] [--device cuda]

Each model is ``build_architecture``'s at its defaults with three output
channels and seeded weights, on a seeded input of ``--size`` (2D models) or
8 x ``--size`` (3D) and a seeded affinity target; the step is the forward,
the two-term affinity ``LegacyCriterion`` and the backward.  The reference
is the step in f64 on the CPU.  Beside it: the f32 step on the CPU, and on
the card with cuDNN and TF32 off, with cuDNN off (PyTorch's own im2col and
cuBLAS convolutions, TF32 off), and with TF32 on.  Each line gives the
loss's and the gradient norm's relative distance from the reference and the
parameter whose gradient lies farthest from it (rel-Fro); then the kernels
of most device time in one f32 step on the card with cuDNN
(``torch.profiler``), which name the convolutions' algorithms.  Nothing in
the package calls this; it diagnoses a card-against-CPU gap.
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import sys

import numpy as np
import torch

SEED = 0
OUT_PLANES = 3


def build(arch: str, shape, aux_out: bool = False):
    """``build_architecture``'s ``arch`` for inputs of ``shape``, seeded."""
    from pctrans_torch.config import get_cfg_defaults
    from pctrans_torch.models import build_architecture

    cfg = get_cfg_defaults()
    cfg.MODEL.ARCHITECTURE = arch
    cfg.MODEL.IN_PLANES, cfg.MODEL.OUT_PLANES = shape[1], OUT_PLANES
    cfg.MODEL.INPUT_SIZE = list(shape[2:])
    cfg.MODEL.AUX_OUT = aux_out
    return build_architecture(cfg, torch.Generator().manual_seed(SEED))


def inputs(shape):
    """A seeded N(0, 1) input and a {0, 1} affinity target (30% ones)."""
    rng = np.random.RandomState(SEED)
    x = rng.randn(*shape).astype(np.float32)
    target = (rng.rand(shape[0], OUT_PLANES, *shape[2:]) > 0.7).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(target)


def step(model, x, target, device, dtype):
    """Forward, criterion and backward of a train-mode copy of ``model`` in
    ``dtype`` on ``device``: (loss, {parameter: gradient in f64 on the CPU},
    the gradient's norm summed in ``dtype`` on ``device``)."""
    from pctrans_torch.losses.legacy import LegacyCriterion

    crit = LegacyCriterion(["2"], [["WeightedBCEWithLogitsLoss", "DiceLoss"]],
                           [["none", "sigmoid"]], [[1.0, 1.0]])
    m = copy.deepcopy(model).to(device, dtype).train()
    loss, _ = crit(m(x.to(device, dtype)), [target.to(device, dtype)], None)
    loss.backward()
    grads = [(n, p.grad.detach()) for n, p in m.named_parameters() if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for _, g in grads]))
    return float(loss.detach()), {n: g.double().cpu() for n, g in grads}, float(norm)


def distance(got, ref) -> str:
    """The loss's and the gradient norm's relative distance from ``ref`` (the
    norm summed in f64, then as the step summed it) and the parameter whose
    gradient is farthest from it (rel-Fro)."""
    def norm(g):
        return float(torch.linalg.vector_norm(torch.stack([v.norm() for v in g.values()])))

    exact = norm(ref[1])

    worst = max(ref[1], key=lambda n: float((got[1][n] - ref[1][n]).norm())
                / max(float(ref[1][n].norm()), 1e-30))
    w = float((got[1][worst] - ref[1][worst]).norm()) / float(ref[1][worst].norm())
    return (f"loss {abs(got[0] - ref[0]) / abs(ref[0]):.2e}, grad norm "
            f"{abs(norm(got[1]) - exact) / exact:.2e} (summed in the step's dtype "
            f"{abs(got[2] - exact) / exact:.2e}), farthest {worst} {w:.2e}")


def card_settings(cudnn: bool, tf32: bool):
    torch.backends.cudnn.enabled = cudnn
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def top_kernels(model, x, target, device, n: int = 10) -> list:
    """(name, ms, launches) of the ``n`` kernels of most device time in one
    f32 step on ``device`` with cuDNN and TF32 off."""
    from torch.profiler import ProfilerActivity, profile

    card_settings(True, False)
    step(model, x, target, device, torch.float32)          # warm up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(model, x, target, device, torch.float32)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in events[:n]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("arch", nargs="+")
    p.add_argument("--batch", type=int, nargs="+", default=[2])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--aux-out", action="store_true", help="DeepLab's aux head")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no card: pass --device cpu for the CPU rows only")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        print(f"card: {card}")
    for arch in args.arch:
        for batch in args.batch:
            spatial = [args.size] * 2 if arch.endswith("2d") or arch.startswith("deeplab") \
                else [8, args.size, args.size]
            shape = (batch, 1, *spatial)
            model = build(arch, shape, args.aux_out)
            x, target = inputs(shape)
            ref = step(model, x, target, torch.device("cpu"), torch.float64)
            print(f"{arch} {list(shape)}: f64 CPU loss {ref[0]:.9f}")
            print(f"  f32 CPU: {distance(step(model, x, target, 'cpu', torch.float32), ref)}")
            if device.type != "cuda":
                continue
            for label, cudnn, tf32 in (("cuDNN, TF32 off", True, False),
                                       ("no cuDNN, TF32 off", False, False),
                                       ("cuDNN, TF32 on", True, True)):
                card_settings(cudnn, tf32)
                got = step(model, x, target, device, torch.float32)
                print(f"  f32 card, {label}: {distance(got, ref)}")
            for name, ms, count in top_kernels(model, x, target, device):
                print(f"    {ms:9.3f} ms {count:4d}x {name[:150]}")
            card_settings(True, False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
