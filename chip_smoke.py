"""On-card smoke run of the PyTorch/CUDA port's CVPPP eval and train paths.

    python3 chip_smoke.py        # one CUDA card; exits non-zero on any failure

Phases:
  1. device: require CUDA, print the card's name and power limit, disable
     TF32 for the f32 phases;
  2. build the CUDA kernels from pctrans_torch/csrc (one nvcc per source,
     all at once);
  3. kernel gates: K1 (ms-deform forward) and K5 (its separable form) at
     the eval shapes, K5 also against K1 and at the entry-point run's train
     and validation shapes (448x448 levels, batch 2 and 4), K2 (ms-deform
     backward) at the train shapes with a share of samples on integral
     pixel coordinates, K3 (mask render) and K4 (upsample+binarize) against
     their plain PyTorch twins on the card, then each one's time beside its
     twin's (K2 alone, and K1 also at the train shapes; K5 beside K1);
  4. the f32 forward of the full-width CVPPP recipe (seeded random weights)
     through the kernels and through the twins, on one batch of four
     synthetic 530x500 scenes;
  5. the f32 train backward of the recipe (SyncBN heads in train mode) on
     two synthetic 448x448 scenes: the pixel decoder's gradients of
     loss_emb + loss_sem through K1/K2 against the twin's;
  6. the bf16 recipe as served: the evaluator over three batches of four
     scenes, with launch counters showing the kernels ran, then K1 timed
     on the value, locations and weights one bf16 forward gives it;
  7. the bf16 recipe as trained: ``make_train_step`` with AdamW and
     WarmupPolyLR, one warm-up step then 5 counted steps on batches of two
     448x448 scenes, with launch counters (K1 = K2 = 6 per step, K3 = 0);
  8. the entry points as users run them: ``scripts/main_torch.py`` with the
     two CVPPP YAMLs on synthetic data (4 bf16 iterations at 448x448 batch
     2, checkpoints at 2 and 4, validation at 4) under
     ``PCTRANS_MSDA_IMPL=pallas`` (K5 = 6 per forward, K1 = 0, K2 = 6 per
     step), then ``scripts/eval_torch.py`` sweeping the two checkpoints
     under the default dispatch (K1 = 6, K3 = 10, K4 = 1 per forward);
  9. one JSON line of kernel results (each with its bound on the card and,
     where one PyTorch call computes the same function, that call's time),
     then the final status line.

Synthetic scenes come from ``pctrans_torch.data.synthetic``; nothing here
or in ``pctrans_torch`` imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 4
IMAGE_HW = (530, 500)
N_EVAL_BATCHES = 3
TRAIN_BATCH = 2                # SOLVER.SAMPLES_PER_BATCH
TRAIN_HW = (448, 448)          # MODEL.INPUT_SIZE
MAX_INSTANCES = 64             # MODEL.MAX_INSTANCES
N_TRAIN_STEPS = 5              # counted, after one warm-up step
SEED = 0                       # of the weights, the scenes and the gates' inputs
REPO = Path(__file__).resolve().parent
ENTRY_ITERS = 4                # iterations of the entry-point run
# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes per second,
# f32 FLOP/s outside the tensor cores, dense TF32 FLOP/s on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def time_ms(fn, warmup: int = 3, reps: int = 20, trials: int = 5) -> float:
    """Time per call of ``fn()`` on the card: CUDA events around ``reps``
    back-to-back warm calls, median over ``trials``.  For a call whose
    host-side wrapper outlasts its kernels this is the host's rate."""
    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_ms(fn, reps: int = 10, kernel: str = "") -> float:
    """Device time per call of ``fn()``: the kernels' own time summed by
    ``torch.profiler``, host overhead excluded; with ``kernel``, only the
    kernels whose name contains it.  A trace can lose events (one in a
    trace of ten calls is common), so each kernel's time is its mean over
    the events the trace kept times its launches per call, round(events /
    reps); a trace that lost more than one event or a tenth of a kernel's
    events is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if kernel in e.key and e.self_device_time_total > 0]
        per_call = [max(1, round(e.count / reps)) for e in events]
        lost = [n * reps - e.count for n, e in zip(per_call, events)]
        expected = sum(per_call) * reps
        if events and all(0 <= k <= max(1, n * reps // 10)
                          for n, k in zip(per_call, lost)):
            if sum(lost):
                print(f"device_ms: the trace lost {sum(lost)} of {expected} device "
                      "events; each kernel's time is its mean over those kept")
            return sum(e.self_device_time_total / e.count * n
                       for n, e in zip(per_call, events)) / 1e3
        print(f"device_ms: the trace holds {sum(e.count for e in events)} device "
              f"events against {expected} expected; tracing again")
    raise AssertionError(f"the profiler lost device events of {kernel or 'the call'}")


def timed(name: str, kernel, twin) -> dict:
    ms, plain = time_ms(kernel), time_ms(twin)
    dev_ms, dev_plain = device_ms(kernel), device_ms(twin)
    print(f"{name}: kernel {ms:.4f} ms/call ({dev_ms:.4f} ms device), "
          f"twin {plain:.4f} ms/call ({dev_plain:.4f} ms device)")
    return {"ms": ms, "plain_ms": plain, "device_ms": dev_ms}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(name: str, n_bytes: float, flops: float, dev_ms: float,
          flop_rate: float = PEAK_F32_FLOP_PER_S, unit: str = "f32") -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM's rate and
    the operations over the rate of the unit that runs them (by default
    f32 on the CUDA cores)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    ms = max(t_bytes, t_ops)
    print(f"{name} bound: {n_bytes / 1e6:.1f} MB -> {t_bytes * 1e3:.2f} us, "
          f"{flops / 1e9:.3f} GFLOP {unit} at {flop_rate / 1e12:.0f} TFLOP/s -> "
          f"{t_ops * 1e3:.2f} us; bound {ms * 1e3:.2f} us by {by}, {ms / dev_ms:.1%} "
          f"of the kernel's {dev_ms:.4f} ms device time")
    return {"bound_ms": ms, "bound_by": by}


def msdeform_samples_inside(shapes, loc) -> int:
    """Samples with a corner inside their level's map: an outside sample
    adds zero, so only these need operations."""
    n = 0
    for lid, (H, W) in enumerate(shapes):
        x = loc[:, :, :, lid, :, 0] * W - 0.5
        y = loc[:, :, :, lid, :, 1] * H - 0.5
        n += int(((x > -1) & (x < W) & (y > -1) & (y < H)).sum())
    return n


def scene_batches(n_batches: int, seed: int, batch: int = BATCH, hw=IMAGE_HW):
    from pctrans_torch.data.synthetic import make_blob_image

    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        items = [make_blob_image(rng, hw) for _ in range(batch)]
        yield {"image": np.stack([i for i, _ in items]),
               "label": np.stack([l for _, l in items])}


# ------------------------------------------------------------ kernel gates
EVAL_SHAPES = [(17, 16), (34, 32), (67, 63)]     # res5, res4, res3 of 530x500
TRAIN_SHAPES = [(14, 14), (28, 28), (56, 56)]    # res5, res4, res3 of 448x448


def msdeform_inputs(dev, g, batch=BATCH, shapes=EVAL_SHAPES):
    S = sum(h * w for h, w in shapes)
    M, D, L, P = 8, 16, 3, 4
    value = torch.randn(batch, S, M, D, device=dev, generator=g)
    # some samples fall outside the map (zero padding path)
    loc = torch.rand(batch, S, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
    w = torch.rand(batch, S, M, L * P, device=dev, generator=g).softmax(-1)
    return value, shapes, loc, w.reshape(batch, S, M, L, P)


def msdeform_work(value, shapes, loc, w):
    """(bytes, FLOP) of one forward call (K1 or K5: the same work) on these
    inputs: each input read once and the output written once; per sample
    inside the map, 4 corners x D channels of multiply-add plus the weighted
    sum, ~10 FLOP per channel."""
    B, Lq, M, D = value.shape[0], loc.shape[1], value.shape[2], value.shape[3]
    out_bytes = B * Lq * M * D * value.element_size()
    flops = msdeform_samples_inside(shapes, loc) * (10 * D + 10)
    return nbytes(value, loc, w) + out_bytes, flops


def msdeform_bound(name, value, shapes, loc, w, dev_ms) -> dict:
    return bound(name, *msdeform_work(value, shapes, loc, w), dev_ms)


def gate_msdeform(dev, inputs):
    from pctrans_torch.ops.msdeform import ms_deform_attn

    value, shapes, loc, w = inputs
    S, M, D = value.shape[1:]
    L, P = loc.shape[3:5]
    out = ms_deform_attn(value, shapes, loc, w)
    torch.cuda.synchronize()
    twin = ms_deform_attn(value, shapes, loc, w, impl="twin")
    err32 = rel_fro(out, twin)
    vb = value.bfloat16()
    err16 = rel_fro(ms_deform_attn(vb, shapes, loc, w),
                    ms_deform_attn(vb, shapes, loc, w, impl="twin"))
    print(f"K1 ms_deform_attn [B={BATCH}, S=Lq={S}, M={M}, D={D}, L={L}, P={P}]: "
          f"f32 rel-Fro {err32:.3e} (<= 1e-5), bf16 rel-Fro {err16:.3e} (<= 1e-2)")
    if not (err32 <= 1e-5 and err16 <= 1e-2):
        raise AssertionError("K1 disagrees with its twin")
    times = timed("K1 bf16 value", lambda: ms_deform_attn(vb, shapes, loc, w),
                  lambda: ms_deform_attn(vb, shapes, loc, w, impl="twin"))
    return {"max_abs_err": float((out - twin).abs().max()), **times,
            **msdeform_bound("K1", vb, shapes, loc, w, times["device_ms"]),
            "library_ms": None}


def time_k1_on_model_inputs(calls) -> dict:
    """K1 on the (value, shapes, locations, weights) of ``calls``, the six
    encoder layers of one bf16 eval forward: ms per launch (call and
    device) beside the twin's, and the bound on those inputs."""
    from pctrans_torch.ops.msdeform import ms_deform_attn

    n = len(calls)
    errs = [rel_fro(ms_deform_attn(*c).float(), ms_deform_attn(*c, impl="twin").float())
            for c in calls]
    print(f"K1 on the inputs of the bf16 eval forward's {n} encoder layers (value "
          f"{calls[0][0].dtype}, locations {calls[0][2].dtype}): rel-Fro to the twin "
          + " ".join(f"{e:.2e}" for e in errs) + " (<= 1e-2)")
    if not max(errs) <= 1e-2:
        raise AssertionError("K1 disagrees with its twin on the model's inputs")
    ms = time_ms(lambda: [ms_deform_attn(*c) for c in calls]) / n
    plain = time_ms(lambda: [ms_deform_attn(*c, impl="twin") for c in calls]) / n
    dev_ms = device_ms(lambda: [ms_deform_attn(*c) for c in calls]) / n
    print(f"K1 on the model's inputs, per launch: kernel {ms:.4f} ms/call "
          f"({dev_ms:.4f} ms device), twin {plain:.4f} ms/call")
    work = [msdeform_work(*c) for c in calls]
    rec = bound("K1 on the model's inputs, per launch", sum(b for b, _ in work) / n,
                sum(f for _, f in work) / n, dev_ms)
    return {"model_ms": ms, "model_device_ms": dev_ms, "model_plain_ms": plain,
            "model_bound_ms": rec["bound_ms"]}


def check_separable(inputs) -> float:
    """K5 against its separable twin and against K1 on ``inputs``; returns
    the largest f32 absolute difference from the twin."""
    from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_separable,
                                            ms_deform_attn_separable_twin)

    value, shapes, loc, w = inputs
    errs = {}
    for name, v in (("f32", value), ("bf16", value.bfloat16())):
        out = ms_deform_attn_separable(v, shapes, loc, w)
        torch.cuda.synchronize()
        twin = ms_deform_attn_separable_twin(v, shapes, loc, w)
        errs[name] = (rel_fro(out, twin),
                      rel_fro(out, ms_deform_attn(v, shapes, loc, w, impl="pallas2")))
        if name == "f32":
            worst = float((out - twin).abs().max())
    print(f"K5 ms_deform_attn_separable [B={value.shape[0]}, S=Lq={value.shape[1]}, "
          f"levels {shapes}]: rel-Fro against its twin / K1: f32 {errs['f32'][0]:.3e} / "
          f"{errs['f32'][1]:.3e} (<= 1e-5), bf16 {errs['bf16'][0]:.3e} / "
          f"{errs['bf16'][1]:.3e} (<= 1e-2)")
    if not (max(errs["f32"]) <= 1e-5 and max(errs["bf16"]) <= 1e-2):
        raise AssertionError("K5 disagrees with its twin or with K1")
    return worst


def gate_separable(dev, g, inputs, k1):
    """K5 against its separable twin and against K1 on the K1 gate's inputs
    (timed beside both) and at the shapes the entry-point run gives it: the
    448x448 levels at the train batch and at the validation batch."""
    from pctrans_torch.ops.msdeform import (ms_deform_attn_separable,
                                            ms_deform_attn_separable_twin)

    worst = check_separable(inputs)
    for batch in (TRAIN_BATCH, BATCH):
        check_separable(msdeform_inputs(dev, g, batch, TRAIN_SHAPES))
    value, shapes, loc, w = inputs
    vb = value.bfloat16()
    times = timed("K5 bf16 value", lambda: ms_deform_attn_separable(vb, shapes, loc, w),
                  lambda: ms_deform_attn_separable_twin(vb, shapes, loc, w))
    print(f"K5 beside K1 on the same inputs: K5 {times['ms']:.4f} ms/call "
          f"({times['device_ms']:.4f} device), K1 {k1['ms']:.4f} ms/call "
          f"({k1['device_ms']:.4f} device), K5/K1 device {times['device_ms'] / k1['device_ms']:.1f}x")
    return {"max_abs_err": worst, **times,
            **msdeform_bound("K5", vb, shapes, loc, w, times["device_ms"]),
            "library_ms": None}


def gate_msdeform_backward(dev, g):
    """K2 through the autograd Function against the twin's autograd at the
    train shapes; a quarter of the samples sit on integral pixel
    coordinates, where both take the hat derivative 0.  Then K2 alone and
    K1 alone at those shapes, each beside its twin, and the two together
    under autograd.  Returns K2's record and K1's train-shape times."""
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward

    shapes = TRAIN_SHAPES
    S = sum(h * w for h, w in shapes)
    B, M, D, L, P = TRAIN_BATCH, 8, 16, 3, 4
    value = torch.randn(B, S, M, D, device=dev, generator=g)
    loc = torch.rand(B, S, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
    for lid, (H, W) in enumerate(shapes):
        size = torch.tensor([W, H], dtype=torch.float32, device=dev)
        k = torch.randint(0, H, loc[:, :, :, lid].shape, device=dev, generator=g)
        pick = torch.rand(loc[:, :, :, lid].shape, device=dev, generator=g) < 0.25
        loc[:, :, :, lid] = torch.where(pick, (k + 0.5) / size, loc[:, :, :, lid])
    w = torch.rand(B, S, M, L * P, device=dev, generator=g).softmax(-1)
    w = w.reshape(B, S, M, L, P)
    gout = torch.randn(B, S, M * D, device=dev, generator=g)

    def grads(v, impl):
        prim = [t.clone().requires_grad_() for t in (v, loc, w)]
        ms_deform_attn(prim[0], shapes, prim[1], prim[2], impl=impl).backward(
            gout.to(v.dtype))
        return [p.grad for p in prim]

    errs, worst = {}, 0.0
    for name, v in (("f32", value), ("bf16", value.bfloat16())):
        ours = grads(v, None)
        torch.cuda.synchronize()
        ref = grads(v, "twin")
        errs[name] = [rel_fro(a, b) for a, b in zip(ours, ref)]
        if name == "f32":
            worst = max(float((a - b).abs().max()) for a, b in zip(ours, ref))
    print(f"K2 ms_deform_attn backward [B={B}, S=Lq={S}, M={M}, D={D}, L={L}, "
          f"P={P}, 25% integral samples]: rel-Fro of d_value, d_loc, d_w: f32 "
          + " ".join(f"{e:.3e}" for e in errs["f32"]) + " (<= 1e-5), bf16 "
          + " ".join(f"{e:.3e}" for e in errs["bf16"]) + " (<= 1e-2)")
    if not (max(errs["f32"]) <= 1e-5 and max(errs["bf16"]) <= 1e-2):
        raise AssertionError("K2 disagrees with the twin's autograd")

    vb, gb = value.bfloat16(), gout.bfloat16()
    inside = msdeform_samples_inside(shapes, loc)
    # K2 alone: its wrapper (the zeroed f32 d_value, the kernel, the casts
    # of the results) beside the twin's autograd
    k2 = timed("K2 ms_deform_attn_backward alone, bf16 value",
               lambda: ms_deform_attn_backward(vb, shapes, loc, w, gb),
               lambda: ms_deform_attn_backward(vb, shapes, loc, w, gb, impl="twin"))
    k2_kernel = device_ms(lambda: ms_deform_attn_backward(vb, shapes, loc, w, gb),
                          kernel="msdeform_bwd_kernel")
    print(f"K2 msdeform_bwd_kernel alone: {k2_kernel:.4f} ms device")
    # value, loc, w, grad_out read once; f32 d_value, d_loc, d_w written
    # once; ~34 FLOP per inside sample and channel (the sample, the dot, two
    # location terms, four d_value terms)
    n_bytes = nbytes(vb, loc, w, gb) + 4 * (value.numel() + loc.numel() + w.numel())
    k2_rec = {"max_abs_err": worst, **k2, "kernel_device_ms": k2_kernel,
              **bound("K2", n_bytes, inside * 34 * D, k2["device_ms"]),
              "library_ms": None}
    k1 = timed("K1 ms_deform_attn alone at the train shapes, bf16 value",
               lambda: ms_deform_attn(vb, shapes, loc, w),
               lambda: ms_deform_attn(vb, shapes, loc, w, impl="twin"))
    k1_bound = msdeform_bound("K1 at the train shapes", vb, shapes, loc, w,
                              k1["device_ms"])

    vg = vb.clone().requires_grad_()
    lr, wr = loc.clone().requires_grad_(), w.clone().requires_grad_()

    def fwd_bwd(impl):
        vg.grad = lr.grad = wr.grad = None
        ms_deform_attn(vg, shapes, lr, wr, impl=impl).backward(gb)

    timed("K1+K2 forward+backward under autograd, bf16 value", lambda: fwd_bwd(None),
          lambda: fwd_bwd("twin"))
    return k2_rec, {"train_ms": k1["ms"], "train_device_ms": k1["device_ms"],
                    "train_plain_ms": k1["plain_ms"],
                    "train_bound_ms": k1_bound["bound_ms"]}


def render_inputs(dev, g):
    """K3's arguments at the CVPPP eval shape (B=4, Q=100, 133x125, Cm=16)."""
    Q, Hm, Wm, Cm, ch = 100, 133, 125, 16, 8
    feats = torch.randn(BATCH, Hm * Wm, Cm, device=dev, generator=g)
    inst_xy = torch.rand(BATCH, Q, 2, device=dev, generator=g) * \
        torch.tensor([Wm * 4.0, Hm * 4.0], device=dev)
    w1 = torch.randn(BATCH, Q, ch, Cm + 2, device=dev, generator=g) * 0.1
    w1[..., :2] *= 0.01                        # rel coords are in pixels
    w2 = torch.randn(BATCH, Q, ch, ch, device=dev, generator=g) * 0.3
    w3 = torch.randn(BATCH, Q, 1, ch, device=dev, generator=g) * 0.3
    b1, b2 = (torch.randn(BATCH, Q, ch, device=dev, generator=g) for _ in range(2))
    b3 = torch.randn(BATCH, Q, 1, device=dev, generator=g)
    return (feats, inst_xy, w1, w2, w3, b1, b2, b3, (Hm, Wm), 4, True)


def gate_render(dev, g):
    from pctrans_torch.ops.render import dynamic_mask_render

    args = render_inputs(dev, g)
    feats, inst_xy, w1, w2, w3, b1, b2, b3, (Hm, Wm) = args[:9]
    Q, ch, Cm = w1.shape[1], w1.shape[2], feats.shape[2]
    out = dynamic_mask_render(*args)
    torch.cuda.synchronize()
    twin = dynamic_mask_render(*args, impl="twin")
    err = rel_fro(out, twin)
    print(f"K3 dynamic_mask_render [B={BATCH}, Q={Q}, HW={Hm}x{Wm}, Cm={Cm}]: "
          f"f32 rel-Fro {err:.3e} (<= 1e-5)")
    if not err <= 1e-5:
        raise AssertionError("K3 disagrees with its twin")
    times = timed("K3", lambda: dynamic_mask_render(*args),
                  lambda: dynamic_mask_render(*args, impl="twin"))
    # three 1x1 layers per (query, pixel): ch*(Cm+2) + ch*ch + ch FMAs.
    # f32-accurate on the tensor cores costs 3 TF32 products each (3xTF32);
    # on the CUDA cores, one f32 FMA each
    flops = 2 * BATCH * Q * Hm * Wm * (ch * (Cm + 2) + ch * ch + ch)
    n_bytes = nbytes(feats, inst_xy, w1, w2, w3, b1, b2, b3, out)
    f32 = bound("K3 (f32, CUDA cores)", n_bytes, flops, times["device_ms"])
    return {"max_abs_err": float((out - twin).abs().max()), **times,
            **bound("K3 (3xTF32, tensor cores)", n_bytes, 3 * flops, times["device_ms"],
                    PEAK_TF32_FLOP_PER_S, "TF32"),
            "bound_ms_f32_cuda_cores": f32["bound_ms"], "library_ms": None}


def gate_resize_binarize(dev, g):
    from pctrans_torch.ops.resize import resize_bilinear
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    K, h, w = 50, 133, 125
    logit_t = math.log(0.69 / 0.31)
    x = torch.randn(BATCH, K, h, w, device=dev, generator=g) * 3.0
    out = resize_bilinear_binarize(x, IMAGE_HW, logit_t)
    torch.cuda.synchronize()
    twin = resize_bilinear_binarize(x, IMAGE_HW, logit_t, impl="twin")
    logits = resize_bilinear(x, IMAGE_HW)
    flips = out != twin
    n_flips = int(flips.sum())
    worst = float((logits[flips] - logit_t).abs().max()) if n_flips else 0.0
    frac = n_flips / out.numel()
    print(f"K4 resize_bilinear_binarize [B={BATCH}, K={K}, {h}x{w} -> "
          f"{IMAGE_HW[0]}x{IMAGE_HW[1]}]: {n_flips} flipped of {out.numel()} "
          f"({frac:.2e}; <= 1e-4), largest |logit - t| at a flip {worst:.3e} "
          "(<= 1e-4)")
    if not (frac <= 1e-4 and worst <= 1e-4):
        raise AssertionError("K4 disagrees with its twin")
    times = timed("K4", lambda: resize_bilinear_binarize(x, IMAGE_HW, logit_t),
                  lambda: resize_bilinear_binarize(x, IMAGE_HW, logit_t,
                                                   impl="twin"))
    # yardstick of two PyTorch calls (no single call binarizes): upsample
    # with F.interpolate, then compare
    library = time_ms(lambda: torch.nn.functional.interpolate(
        x, IMAGE_HW, mode="bilinear", align_corners=False) > logit_t)
    print(f"K4 yardstick F.interpolate(bilinear) > t: {library:.4f} ms/call")
    # two lerps along each axis and a compare, ~10 FLOP per output pixel
    flops = 10 * out.numel()
    return {"max_abs_err": float((out.int() - twin.int()).abs().max()), **times,
            **bound("K4", nbytes(x, out), flops, times["device_ms"]),
            "library_ms": library}


# ----------------------------------------------------------------- slices
def build_model(config, dev):
    from pctrans_torch.models import PCTransModel

    model = PCTransModel(config, generator=torch.Generator().manual_seed(SEED))
    return model.to(dev).eval()


def stage_sizes(hw):
    """(res2, res3, res4, res5) grids of the ResNet at input ``hw``: the stem
    conv, the max-pool and each stage's stride-2 conv take ceil(n / 2)."""
    sizes = [tuple(-(-(-(-n // 2)) // 2) for n in hw)]            # res2
    for _ in range(3):
        sizes.append(tuple(-(-n // 2) for n in sizes[-1]))
    return sizes


def attn_mask_flips(masks_a, masks_b, hw):
    """Attention-mask bits (sigmoid < 0.5 at the next layer's level) that
    differ between two runs, per decoder layer."""
    from pctrans_torch.ops.resize import resize_bilinear

    sizes = stage_sizes(hw)[:0:-1]          # the decoder's res5, res4, res3
    flips = []
    for j, (a, b) in enumerate(zip(masks_a[:-1], masks_b[:-1])):
        size = sizes[j % len(sizes)]
        fa = torch.sigmoid(resize_bilinear(a.float(), size)) < 0.5
        fb = torch.sigmoid(resize_bilinear(b.float(), size)) < 0.5
        flips.append(int((fa != fb).sum()))
    return flips


def slice_f32(dev):
    from pctrans_torch.config import CVPPP_RECIPE

    model = build_model(dataclasses.replace(CVPPP_RECIPE, dtype="float32"), dev)
    batch = next(scene_batches(1, SEED))
    x = torch.from_numpy(batch["image"]).to(dev)
    with torch.inference_mode():
        out = model(x)
        ref = model(x, impl="twin")
    masks_out = out["aux_masks"] + [out["pred_masks"]]
    masks_ref = ref["aux_masks"] + [ref["pred_masks"]]
    errs = [rel_fro(a.float(), b.float()) for a, b in zip(masks_out, masks_ref)]
    flips = attn_mask_flips(masks_out, masks_ref, IMAGE_HW)
    # The forward is discontinuous at the attention-mask threshold
    # (sigmoid < 0.5): mask j's bits steer decoder layer j, so a bit flipped
    # by summation order lets the two runs part from layer j on.  Gate every
    # mask up to and including the first one with a flip (all of them,
    # pred_masks included, when none flips).
    n_gated = next((j for j, f in enumerate(flips) if f), len(errs) - 1) + 1
    print("f32 slice, kernels vs twins, rel-Fro per mask prediction: "
          + " ".join(f"{e:.2e}" for e in errs)
          + "; attention-mask bits flipped per layer: "
          + " ".join(map(str, flips))
          + f"; gated (<= 1e-3): the first {n_gated} of {len(errs)}")
    if not all(torch.isfinite(t).all() for t in (out["pred_masks"], ref["pred_masks"])):
        raise AssertionError("non-finite f32 mask logits")
    if not max(errs[:n_gated]) <= 1e-3:
        raise AssertionError(f"f32 slice masks rel-Fro {max(errs[:n_gated]):.3e} "
                             "> 1e-3 before the first attention-mask flip")


def slice_bf16(dev, card):
    import pctrans_torch.models.pixel_decoder as pixel_decoder
    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.engine.evaluator import Evaluator
    from pctrans_torch.ops.msdeform import ms_deform_attn
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    model = build_model(CVPPP_RECIPE, dev)
    ev = Evaluator(model, top_k=50)
    batches = list(scene_batches(N_EVAL_BATCHES, SEED + 1))
    ev.predict_labels(batches[0]["image"])            # warm-up, not counted
    torch.cuda.synchronize()

    counters = (ms_deform_attn, dynamic_mask_render, resize_bilinear_binarize)
    for fn in counters:
        fn.launches = 0
    ev.forwards = 0
    t0 = time.perf_counter()
    res = ev.eval_cvppp(batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    fwd = ev.forwards
    print(f"bf16 eval over {N_EVAL_BATCHES} batches of {BATCH}: {fwd} forwards "
          f"(full-Q re-runs included); launches K1 {launches[0]}, "
          f"K3 {launches[1]}, K4 {launches[2]}")
    c = CVPPP_RECIPE
    if fwd < N_EVAL_BATCHES or launches != [c.enc_layers * fwd,
                                            (c.dec_layers + 1) * fwd, fwd]:
        raise AssertionError("launch counts do not match the forwards run")
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"non-finite metrics {res}")
    print(f"SBD {res['SBD']:.4f}, |DiC| {res['absDiffFG']:.4f} "
          "(random weights: shows only that the chain ran)")

    labels = ev.predict_labels(batches[0]["image"])
    if labels.shape != (BATCH,) + IMAGE_HW:
        raise AssertionError(f"labels shape {labels.shape}")
    print("instances per image of batch 0: "
          + " ".join(str(int(l.max())) for l in labels))
    x = torch.from_numpy(batches[0]["image"]).to(dev)
    k1_calls = []

    def keep_k1_inputs(value, shapes, loc, w, impl=None):
        k1_calls.append((value, tuple(shapes), loc, w))
        return ms_deform_attn(value, shapes, loc, w, impl=impl)

    with torch.inference_mode():
        pixel_decoder.ms_deform_attn = keep_k1_inputs
        out = model(x)
        pixel_decoder.ms_deform_attn = ms_deform_attn
        if len(k1_calls) != c.enc_layers:
            raise AssertionError(f"{len(k1_calls)} ms-deform calls in one forward")
        for k in ("pred_masks", "reference_points", "query_emb", "sem_mask",
                  "mask_features"):
            if not torch.isfinite(out[k].float()).all():
                raise AssertionError(f"non-finite {k}")
        if tuple(out["pred_masks"].shape) != (BATCH, c.num_queries,
                                               *stage_sizes(IMAGE_HW)[0]):
            raise AssertionError(f"pred_masks shape {tuple(out['pred_masks'].shape)}")
        fwd_ms = time_ms(lambda: model(x), warmup=2, reps=5)
        fwd_dev = device_ms(lambda: model(x), reps=5)
        k1_model = time_k1_on_model_inputs(k1_calls)
    print(f"bf16 forward {fwd_ms:.3f} ms/batch of {BATCH} (CUDA events), "
          f"{fwd_dev:.3f} ms of it device time ({1 - fwd_dev / fwd_ms:.1%} "
          f"idle); end to end {N_EVAL_BATCHES * BATCH / wall:.3f} img/s "
          f"({wall:.3f} s wall for {N_EVAL_BATCHES * BATCH} images, host "
          f"postprocess included) on {card}")
    return launches, k1_model


def train_f32_backward(dev):
    """Gradients of loss_emb + loss_sem through the kernels (K1 forward, K2
    backward) and through the twins.  The two losses read the backbone, the
    pixel decoder and the seg head only: no matching and no attention-mask
    threshold, so the comparison has no discontinuity."""
    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.data.targets import targets_from_labels
    from pctrans_torch.losses.criterion import SetCriterion, CVPPP_CRITERION
    from pctrans_torch.losses.discriminative import discriminative_loss

    model = build_model(dataclasses.replace(CVPPP_RECIPE, dtype="float32"), dev)
    model.train()
    batch = next(scene_batches(1, SEED, TRAIN_BATCH, TRAIN_HW))
    x = torch.from_numpy(batch["image"]).to(dev)
    targets = targets_from_labels(torch.from_numpy(batch["label"]).to(dev).int(),
                                  MAX_INSTANCES)
    crit = SetCriterion(CVPPP_CRITERION)

    def grads(impl):
        model.zero_grad(set_to_none=True)
        out = model(x, impl=impl)
        loss = (crit.sem_loss(out["sem_mask"], targets["fg_mask"])
                + discriminative_loss(out["mask_features"], targets["seg"],
                                      MAX_INSTANCES))
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in
                                      model.pixel_decoder.named_parameters()}

    loss_k, ours = grads(None)
    loss_t, ref = grads("twin")
    errs = {n: rel_fro(ours[n], ref[n]) for n in ref if float(ref[n].norm()) > 0}
    zero = [n for n in ref if float(ref[n].norm()) == 0]
    name, worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"f32 train backward, kernels vs twins, loss_emb + loss_sem "
          f"{loss_k:.6f} vs {loss_t:.6f}: rel-Fro of {len(errs)} pixel-decoder "
          f"gradients, largest {worst:.3e} ({name}), median "
          f"{statistics.median(errs.values()):.3e} (<= 1e-3); zero in the "
          f"twin: {zero}")
    if not worst <= 1e-3 or any(float(ours[n].norm()) != 0 for n in zero):
        raise AssertionError("f32 train gradients through K1/K2 disagree "
                             "with the twin's")


def train_bf16(dev, card):
    from torch.profiler import ProfilerActivity, profile

    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.engine.solver import (CVPPP_SOLVER, build_lr_scheduler,
                                             build_optimizer)
    from pctrans_torch.engine.train_step import make_train_step
    from pctrans_torch.losses.criterion import SetCriterion, CVPPP_CRITERION
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward
    from pctrans_torch.ops.render import dynamic_mask_render

    model = build_model(CVPPP_RECIPE, dev)
    opt = build_optimizer(model, CVPPP_SOLVER)
    step = make_train_step(model, SetCriterion(CVPPP_CRITERION), opt,
                           build_lr_scheduler(opt, CVPPP_SOLVER), MAX_INSTANCES,
                           torch.Generator(device=dev).manual_seed(SEED))
    batches = list(scene_batches(N_TRAIN_STEPS + 3, SEED + 2, TRAIN_BATCH, TRAIN_HW))
    step(batches[0])                                   # warm-up, not counted
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    counters = (ms_deform_attn, ms_deform_attn_backward, dynamic_mask_render)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = []
    for batch in batches[1:1 + N_TRAIN_STEPS]:
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = [fn.launches for fn in counters]
    peak = torch.cuda.max_memory_allocated(dev)
    c = CVPPP_RECIPE
    print(f"bf16 train, {N_TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]}: launches K1 {launches[0]}, K2 {launches[1]}, "
          f"K3 {launches[2]}")
    if launches != [c.enc_layers * N_TRAIN_STEPS] * 2 + [0]:
        raise AssertionError("launch counts do not match the train steps run")
    losses = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    changed = sum(bool((p.detach() != before[n]).any())
                  for n, p in model.named_parameters())
    print(f"parameter tensors changed by the steps: {changed} of {len(before)}")
    if changed < 0.9 * len(before):
        raise AssertionError("the optimizer left the parameters unchanged")

    n_prof = 2
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in batches[1 + N_TRAIN_STEPS:]:
            step(batch)
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in events) / n_prof / 1e3
    host_ms = statistics.median(step_ms)
    print(f"bf16 train step {host_ms:.3f} ms (host clock, median of "
          f"{N_TRAIN_STEPS}: " + " ".join(f"{t:.1f}" for t in step_ms)
          + f"), {dev_ms:.3f} ms of it device time ({1 - dev_ms / host_ms:.1%} "
          f"idle), peak {peak / 2**30:.3f} GiB allocated, on {card}")
    print("train step device time by kernel (top 20, ms per step, launches):")
    for e in events[:20]:
        print(f"  {e.self_device_time_total / n_prof / 1e3:8.3f} "
              f"{e.count // n_prof:5d}  {e.key[:110]}")
    print("losses of the last counted step: " + json.dumps(
        {k: round(v, 6) for k, v in losses.items()}))
    return launches


def entry_points(card):
    """``scripts/main_torch.py`` as a user runs it, under
    ``PCTRANS_MSDA_IMPL=pallas`` (K5), then ``scripts/eval_torch.py`` over
    its checkpoints under the default dispatch (K1)."""
    import pctrans_torch.engine.trainer as trainer_module
    from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_backward,
                                            ms_deform_attn_separable)
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    sys.path.insert(0, str(REPO / "scripts"))
    import eval_torch
    import main_torch

    counters = (ms_deform_attn, ms_deform_attn_separable, ms_deform_attn_backward,
                dynamic_mask_render, resize_bilinear_binarize)
    step_ms = []
    make_step = trainer_module.make_train_step

    def timed_steps(*args, **kwargs):        # host ms per train step
        step = make_step(*args, **kwargs)

        def run(batch, **kw):
            t0 = time.perf_counter()
            out = step(batch, **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        cfg_args = ["--config-base", str(REPO / "configs/CVPPP/CVPPP-PCTrans-Base.yaml"),
                    "--config-file", str(REPO / "configs/CVPPP/CVPPP-PCTrans.yaml")]
        opts = ["DATASET.DATA_TYPE", "synthetic",
                "SOLVER.ITERATION_TOTAL", str(ENTRY_ITERS), "SOLVER.ITERATION_SAVE", "2",
                "SOLVER.START_SAVE", "0", "SOLVER.ITERATION_VAL", str(ENTRY_ITERS),
                "DATASET.OUTPUT_PATH", tmp, "INFERENCE.OUTPUT_PATH", f"{tmp}/test",
                "MONITOR.TENSORBOARD", "False", "MONITOR.ITERATION_NUM", "[1, 200]"]
        for fn in counters:
            fn.launches = 0
        trainer_module.make_train_step = timed_steps
        os.environ["PCTRANS_MSDA_IMPL"] = "pallas"
        try:
            t0 = time.perf_counter()
            trainer = main_torch.main(cfg_args + ["--opts", *opts])
            train_wall = time.perf_counter() - t0
        finally:
            del os.environ["PCTRANS_MSDA_IMPL"]
            trainer_module.make_train_step = make_step
        k1, k5, k2, k3, k4 = [fn.launches for fn in counters]
        fwd = trainer.evaluator.forwards
        c = trainer.model_config
        print(f"main_torch.py, PCTRANS_MSDA_IMPL=pallas, {ENTRY_ITERS} bf16 iterations "
              f"of {trainer.cfg.SOLVER.SAMPLES_PER_BATCH}x{trainer.cfg.MODEL.INPUT_SIZE} + "
              f"{fwd} validation forwards: launches K5 {k5}, K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4}")
        if [k5, k1, k2, k3, k4] != [c.enc_layers * (ENTRY_ITERS + fwd), 0,
                                    c.enc_layers * ENTRY_ITERS, (c.dec_layers + 1) * fwd, fwd]:
            raise AssertionError("entry-point launch counts do not match the run")
        lines = [json.loads(l) for l in Path(tmp, "metrics.jsonl").read_text().splitlines()]
        train = [r for r in lines if "eval" not in r]
        evals = [r["eval"] for r in lines if "eval" in r]
        if ([r["iter"] for r in train] != list(range(ENTRY_ITERS)) or len(evals) != 1
                or any(len(r) < 10 for r in train)
                or not all(math.isfinite(v) for r in train + evals for v in r.values())):
            raise AssertionError(f"metrics.jsonl records {lines}")
        saved = sorted(f for f in os.listdir(tmp) if f.endswith(".pth.tar"))
        if saved != ["checkpoint_000002.pth.tar", "checkpoint_000004.pth.tar",
                     "checkpoint_best.pth.tar"]:
            raise AssertionError(f"checkpoints {saved}")
        k5_train = k5
        print(f"per-loss records of {len(train[0]) - 2} terms, finite; validation "
              f"{evals[0]}; checkpoints {saved}")
        print(f"host ms per train iteration (synchronised): "
              + " ".join(f"{t:.1f}" for t in step_ms)
              + f"; main_torch.py wall {train_wall:.3f} s, on {card}")

        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        records = eval_torch.main(cfg_args + ["--start", "0", "--out", f"{tmp}/sweep.json",
                                              "--opts", *opts])
        sweep_wall = time.perf_counter() - t0
        k1, k5, k2, k3, k4 = [fn.launches for fn in counters]
        print(f"eval_torch.py, default dispatch: {len(records)} records "
              f"{records}; launches K1 {k1}, K3 {k3}, K4 {k4} (one per forward), "
              f"K5 {k5}, K2 {k2}; sweep wall {sweep_wall:.3f} s, on {card}")
        if [r["iter"] for r in records] != [2, 4] or \
                json.loads(Path(tmp, "sweep.json").read_text()) != records:
            raise AssertionError("the sweep did not score the two checkpoints")
        if k4 < 4 or [k1, k3, k5, k2] != [c.enc_layers * k4, (c.dec_layers + 1) * k4, 0, 0]:
            raise AssertionError("sweep launch counts do not match its forwards")
    return k5_train


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pctrans_torch.ops import _build      # fails outside a checkout

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())

    g = torch.Generator(device=dev).manual_seed(SEED)
    eval_inputs = msdeform_inputs(dev, g)
    k1_gate = gate_msdeform(dev, eval_inputs)
    k5_gate = gate_separable(dev, g, eval_inputs, k1_gate)
    del eval_inputs
    k2_gate, k1_train = gate_msdeform_backward(dev, g)
    k1_gate.update(k1_train)
    gates = [k1_gate, k2_gate, gate_render(dev, g), gate_resize_binarize(dev, g),
             k5_gate]
    slice_f32(dev)
    train_f32_backward(dev)
    (k1_eval, k3, k4), k1_model = slice_bf16(dev, card)
    k1_gate.update(k1_model)
    k1, k2, _ = train_bf16(dev, card)
    k5 = entry_points(card)
    print(f"main paths: train K1 {k1}, K2 {k2}; eval K1 {k1_eval}, K3 {k3}, "
          f"K4 {k4}; entry points under PCTRANS_MSDA_IMPL=pallas K5 {k5} (the "
          "kernels line reports K1/K2 from train, K3/K4 from eval, K5 from the "
          "entry-point run)")
    launches = [k1, k2, k3, k4, k5]

    meta = [("K1 ms_deform_attn forward", "pctrans_torch/csrc/msdeform_fwd.cu",
             "pctrans_tpu/ops/msdeform_pallas2.py:73"),
            ("K2 ms_deform_attn backward (timed alone, its wrapper)",
             "pctrans_torch/csrc/msdeform_bwd.cu",
             "pctrans_tpu/ops/msdeform_pallas2.py:118"),
            ("K3 dynamic_mask_render", "pctrans_torch/csrc/render.cu",
             "pctrans_tpu/ops/render_pallas.py:96"),
            ("K4 resize_bilinear_binarize (library_ms: F.interpolate(bilinear) > t, "
             "a two-call yardstick)", "pctrans_torch/csrc/resize_binarize.cu",
             "pctrans_tpu/ops/resize_pallas.py:52"),
            ("K5 ms_deform_attn_separable forward", "pctrans_torch/csrc/msdeform_separable.cu",
             "pctrans_tpu/ops/msdeform_pallas.py:79")]
    keys = ("max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{"name": n, "route": "cuda", "source": s, "replaces": r,
                "launches": k, **{key: gate[key] for key in keys},
                **{key: v for key, v in gate.items() if key not in keys}}
               for (n, s, r), k, gate in zip(meta, launches, gates)]
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
