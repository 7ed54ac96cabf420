"""On-card smoke run of the PyTorch/CUDA port's CVPPP eval and train paths.

    python3 chip_smoke.py        # one CUDA card; exits non-zero on any failure

Phases:
  1. device: require CUDA, print the card's name and power limit, disable
     TF32 for the f32 phases;
  2. build the CUDA kernels from pctrans_torch/csrc (first use);
  3. kernel gates: K1 (ms-deform forward) at the eval shapes, K2 (ms-deform
     backward) at the train shapes with a share of samples on integral
     pixel coordinates, K3 (mask render) and K4 (upsample+binarize) against
     their plain PyTorch twins on the card, then each one's time beside its
     twin's (K2 timed as K1+K2 forward+backward against the twin's);
  4. the f32 forward of the full-width CVPPP recipe (seeded random weights)
     through the kernels and through the twins, on one batch of four
     synthetic 530x500 scenes;
  5. the f32 train backward of the recipe (SyncBN heads in train mode) on
     two synthetic 448x448 scenes: the pixel decoder's gradients of
     loss_emb + loss_sem through K1/K2 against the twin's;
  6. the bf16 recipe as served: the evaluator over three batches of four
     scenes, with launch counters showing the kernels ran;
  7. the bf16 recipe as trained: ``make_train_step`` with AdamW and
     WarmupPolyLR, one warm-up step then 5 counted steps on batches of two
     448x448 scenes, with launch counters (K1 = K2 = 6 per step, K3 = 0);
  8. one JSON line of kernel results, then the final status line.

Synthetic scenes come from ``pctrans_torch.data.synthetic``; nothing here
or in ``pctrans_torch`` imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

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


def device_ms(fn, reps: int = 10) -> float:
    """Device time per call of ``fn()``: the kernels' own time summed by
    ``torch.profiler``, host overhead excluded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / reps / 1e3


def timed(name: str, kernel, twin) -> dict:
    ms, plain = time_ms(kernel), time_ms(twin)
    dev_ms, dev_plain = device_ms(kernel), device_ms(twin)
    print(f"{name}: kernel {ms:.4f} ms/call ({dev_ms:.4f} ms device), "
          f"twin {plain:.4f} ms/call ({dev_plain:.4f} ms device)")
    return {"ms": ms, "plain_ms": plain}


def scene_batches(n_batches: int, seed: int, batch: int = BATCH, hw=IMAGE_HW):
    from pctrans_torch.data.synthetic import make_blob_image

    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        items = [make_blob_image(rng, hw) for _ in range(batch)]
        yield {"image": np.stack([i for i, _ in items]),
               "label": np.stack([l for _, l in items])}


# ------------------------------------------------------------ kernel gates
def gate_msdeform(dev, g):
    from pctrans_torch.ops.msdeform import ms_deform_attn

    shapes = [(17, 16), (34, 32), (67, 63)]       # res5, res4, res3 of 530x500
    S = sum(h * w for h, w in shapes)
    M, D, L, P = 8, 16, 3, 4
    value = torch.randn(BATCH, S, M, D, device=dev, generator=g)
    # some samples fall outside the map (zero padding path)
    loc = torch.rand(BATCH, S, M, L, P, 2, device=dev, generator=g) * 1.2 - 0.1
    w = torch.rand(BATCH, S, M, L * P, device=dev, generator=g).softmax(-1)
    w = w.reshape(BATCH, S, M, L, P)
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
    return {"max_abs_err": float((out - twin).abs().max()), **times}


def gate_msdeform_backward(dev, g):
    """K2 through the autograd Function against the twin's autograd at the
    train shapes; a quarter of the samples sit on integral pixel
    coordinates, where both take the hat derivative 0."""
    from pctrans_torch.ops.msdeform import ms_deform_attn

    shapes = [(14, 14), (28, 28), (56, 56)]       # res5, res4, res3 of 448x448
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

    vb = value.bfloat16().requires_grad_()
    lr, wr = loc.clone().requires_grad_(), w.clone().requires_grad_()
    gb = gout.bfloat16()

    def fwd_bwd(impl):
        vb.grad = lr.grad = wr.grad = None
        ms_deform_attn(vb, shapes, lr, wr, impl=impl).backward(gb)

    times = timed("K1+K2 forward+backward, bf16 value", lambda: fwd_bwd(None),
                  lambda: fwd_bwd("twin"))
    return {"max_abs_err": worst, **times}


def gate_render(dev, g):
    from pctrans_torch.ops.render import dynamic_mask_render

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
    args = (feats, inst_xy, w1, w2, w3, b1, b2, b3, (Hm, Wm), 4, True)
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
    return {"max_abs_err": float((out - twin).abs().max()), **times}


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
    return {"max_abs_err": float((out.int() - twin.int()).abs().max()), **times}


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
    with torch.inference_mode():
        out = model(x)
        for k in ("pred_masks", "reference_points", "query_emb", "sem_mask",
                  "mask_features"):
            if not torch.isfinite(out[k].float()).all():
                raise AssertionError(f"non-finite {k}")
        if tuple(out["pred_masks"].shape) != (BATCH, c.num_queries,
                                               *stage_sizes(IMAGE_HW)[0]):
            raise AssertionError(f"pred_masks shape {tuple(out['pred_masks'].shape)}")
        fwd_ms = time_ms(lambda: model(x), warmup=2, reps=5)
        fwd_dev = device_ms(lambda: model(x), reps=5)
    print(f"bf16 forward {fwd_ms:.3f} ms/batch of {BATCH} (CUDA events), "
          f"{fwd_dev:.3f} ms of it device time ({1 - fwd_dev / fwd_ms:.1%} "
          f"idle); end to end {N_EVAL_BATCHES * BATCH / wall:.3f} img/s "
          f"({wall:.3f} s wall for {N_EVAL_BATCHES * BATCH} images, host "
          f"postprocess included) on {card}")
    return launches


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
    gates = [gate_msdeform(dev, g), gate_msdeform_backward(dev, g),
             gate_render(dev, g), gate_resize_binarize(dev, g)]
    slice_f32(dev)
    train_f32_backward(dev)
    k1_eval, k3, k4 = slice_bf16(dev, card)
    k1, k2, _ = train_bf16(dev, card)
    print(f"main paths: train K1 {k1}, K2 {k2}; eval K1 {k1_eval}, K3 {k3}, "
          f"K4 {k4} (the kernels line reports K1/K2 from train, K3/K4 from eval)")
    launches = [k1, k2, k3, k4]

    meta = [("K1 ms_deform_attn forward", "pctrans_torch/csrc/msdeform_fwd.cu",
             "pctrans_tpu/ops/msdeform_pallas2.py:73"),
            ("K2 ms_deform_attn backward (timed as K1+K2 forward+backward)",
             "pctrans_torch/csrc/msdeform_bwd.cu",
             "pctrans_tpu/ops/msdeform_pallas2.py:118"),
            ("K3 dynamic_mask_render", "pctrans_torch/csrc/render.cu",
             "pctrans_tpu/ops/render_pallas.py:96"),
            ("K4 resize_bilinear_binarize", "pctrans_torch/csrc/resize_binarize.cu",
             "pctrans_tpu/ops/resize_pallas.py:52")]
    kernels = [{"name": n, "route": "cuda", "source": s, "replaces": r,
                "launches": k, **gate}
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
