"""On-card smoke run of the PyTorch/CUDA port's CVPPP and BBBC eval and train
paths, of the alternative components (Swin-T, the FPN decoders, the DETR
predictor, the stride-8 FPN swap), of multi-process training, the label
pipeline, the CVPPP submission, the monitor's profiler window, the on-disk
dataset readers, the legacy model zoo and the volume data.

    python3 chip_smoke.py        # one CUDA card; exits non-zero on any failure

Phases:
  1. device: require CUDA, print the card's name and power limit, disable
     TF32 for the f32 phases;
  2. build the CUDA kernels from pctrans_torch/csrc (one nvcc per source,
     all at once);
  3. kernel gates: K1 (ms-deform forward) and K5 (its separable form) at
     the eval shapes, K5 also against K1 and at phase 8's train and
     validation shapes (448x448 levels, batch 2 and 4), K2 (ms-deform
     backward) at the train shapes with a share of samples on integral
     pixel coordinates and on a contention case (every query of a head in
     the same 2x2 cells of the 14x14 level), K3 (mask render) and K4
     (upsample+binarize, at K=50 and K=100 masks of the CVPPP eval and at
     the BBBC eval's [2, 300, 130, 174] -> 520x696) against their plain
     PyTorch twins on the card (K5 in bf16 at rel-Fro 1e-4: it rounds
     hat_x as its twin does), then each one's time beside its twin's (K2
     alone, also on the contention case, and K1 also at the train shapes;
     K5 beside K1); then K7 (the masks' statistics) at the eval path's
     four shapes (CVPPP's 50 and 100 masks at 530x500, BBBC's 160 and 300
     at 520x696), bit-equal to its twin, timed beside it and beside an f32
     and a bf16 ``bmm``; then K8 (the scored images' label-pair tables) at
     the BBBC and CVPPP eval batches, an odd width and a misaligned start,
     bit-equal to its twin (``torch.bincount``), timed beside it at the two
     eval batches;
  4. the f32 forward of the full-width CVPPP recipe (seeded random weights)
     through the kernels and through the twins (inside ``_build.twins()``),
     on one batch of four synthetic 530x500 scenes;
  5. the f32 train backward of the recipe (SyncBN heads in train mode) on
     two synthetic 448x448 scenes: the pixel decoder's gradients of
     loss_emb + loss_sem through K1/K2 against the twin's;
  6. the bf16 CVPPP recipe as served: the evaluator, which labels through
     the device postprocess, over three batches of four scenes, with launch
     counters showing the kernels ran (K1 = 6, K3 = 10, K4 = 1 per forward;
     K7 = 1 per forward and 1 per batch for the merged masks; K8 = 1 per
     batch)
     and the end-to-end img/s; batch 0's label maps equal to the numpy
     oracle's on the same u8 masks; the device postprocess's ms per batch
     beside the oracle's; the host fetches of one ``predict_labels`` (the
     statistics and the label map, no mask stack); then K1 gated and timed
     on the value, locations and weights one bf16 forward gives it, and K5
     (``ms_deform_attn_separable``, which no path calls) on the same; then
     the recipe's dtype map (every module's output dtypes, eval and train
     mode, at 64x64) on the card against a CPU copy: equal, or the phase
     fails;
  6b. the bf16 BBBC recipe as served (``BBBC_RECIPE``: Q=300, TOP_K 160,
     threshold 0.05): ``Evaluator(dataset="bbbc")`` over three batches of
     two 520x696 nuclei scenes (50-148 nuclei of radius 10-22 px) through
     ``test_bbbc``, with the same launch counts, AJI/F1/detF1/PQ finite,
     batch 0's label maps equal to ``instance_inference_bbbc``'s (on a
     difference, the clusters whose fractional areas order otherwise in f32
     are printed), the device postprocess's ms per batch, and the forward's
     ms, device ms and idle share; random weights make every batch re-run
     at full Q (K=300);
  7. the bf16 recipe as trained: ``make_train_step`` with AdamW and
     WarmupPolyLR, one warm-up step then 5 counted steps on batches of two
     448x448 scenes, with launch counters (K1 = K2 = 6 per step, K3 = 0),
     then K2 gated and timed on the value, locations, weights and output
     gradients the warm-up step gave it;
  7b. the bf16 recipe trained under the sampled point modes: 1 + 3 steps
     each of ``shared``, ``weighted`` and ``topk`` (bf16 sampling), then of
     the published estimator (``exact``, CANDIDATE_RATIO 3, EXACT_TARGETS,
     f32 sampling, UPSAMPLE2X): host ms per step, device ms, idle share,
     peak GiB, K1/K2 launches per step (6 each); then the criterion on one
     step's outputs, targets and draws on the card and on a CPU copy: each
     loss and each lane's matched cost within rel 1e-4;
  8. the entry points as users run them: ``scripts/main_torch.py`` with the
     two CVPPP YAMLs on synthetic data (4 bf16 iterations at 448x448 batch
     2, checkpoints at 2 and 4, validation at 4; K1 = 6 per forward, K2 =
     6 per step, K5 = 0), then ``scripts/eval_torch.py`` sweeping the two
     checkpoints (K1 = 6, K3 = 10, K4 = 1 per forward); then
     ``main_torch.py`` with the two BBBC YAMLs on ``synthetic_bbbc`` (2
     bf16 iterations at 512x512 batch 2, MAX_INSTANCES 128, a checkpoint
     and a validation at 2 that runs ``test_bbbc``, writes AJI to
     ``logging.txt`` and keeps ``checkpoint_best``; K1 = K2 = 6 per step)
     and ``eval_torch.py --name bbbc`` over that checkpoint;
  8c. ``main_torch.py`` with the CVPPP YAMLs under the other settings (the
     reference estimator, WarmupCosineLR, gradient clipping, SWA from
     iteration 2 merged every iteration with a 2-batch BatchNorm refresh,
     TRANSFER_UINT8): 4 iterations, checkpoints at 2 and 4,
     ``checkpoint_swa.pth.tar`` written, every logged LR the one the
     optimizer applied; then ``eval_torch.py --checkpoint`` over the SWA
     checkpoint (K1 = 6, K3 = 10, K4 = 1 per forward);
  9. the Swin-T PCTrans (the CVPPP recipe with ``MODEL.BACKBONE.NAME
     D2SwinTransformer``: embed 96, depths 2/2/6/2, heads 3/6/12/24,
     window 7, drop path 0.3) at full width: the f32 forward kernels vs
     twins as in phase 4 (the attention's twin: K6 is bf16 only); the bf16 evaluator over
     three batches of four 530x500 scenes (K1 = 6, K3 = 10, K4 = 1, K6 =
     12 per forward; labels against the numpy oracle) with K1 and K6 (the
     fused window attention, within 2^-9 rel-Fro of its twin) gated and
     timed on their own inputs; 1 + 3 bf16 train steps at 448x448 batch 2
     with drop path on (K1 = K2 = 6 per step, K6 = 0) with K2 gated on one
     step's own inputs; then ``main_torch.py --opts MODEL.BACKBONE.NAME
     D2SwinTransformer`` (2 iterations, a checkpoint at 2; K6 = 0) and
     ``eval_torch.py`` over that checkpoint (K6 = 12 per forward);
  9b. the other components at the recipe's width, each with its f32
     forward kernels vs twins and one bf16 eval batch of four 530x500
     scenes (labels against the numpy oracle): R-50 + ``fpn_legacy_swap``
     (K1 = 6, K3 = 10, K4 = 1 per forward; K3 and K4 gated and timed on the
     stride-8 grid's own inputs, 67x63), R-50 + ``BasePixelDecoder`` (K3,
     K4), R-50 + ``TransformerEncoderPixelDecoder`` +
     ``StandardTransformerDecoder`` (K4);
  10. multi-card training: (a) ``scripts/main_torch.py --distributed`` as
     world 1 through env:// on NCCL with phase 8's arguments, its
     per-iteration losses within rel 1e-3 of phase 8's (both through K1)
     and its files those of one run; (b) two gloo ranks on the
     one card (each a ``chip_smoke.py --dist-worker`` process under a
     timeout), 1 + 2 bf16 train steps at per-rank batch 1 against one
     process at batch 2: the losses, gradient global norms and SyncBN
     running statistics of each step (the first within rel 5e-2) and K1/K2
     launches per rank (6 each per step); (c) the same on NCCL, one card per
     rank, only where a second card exists;
  11. the label pipeline against the serial ``predict_labels``: CVPPP
     (530x500, batch 4) and BBBC (520x696, batch 2, Q=300), three batches
     each with the same random weights, labels bit-equal, img/s and the
     device's idle share of each;
  12. ``test_cvppp``'s generator over a synthetic CVPPP test split (rgb and
     fg; a padded last batch) through the pipeline and ``merge_func``:
     instances per plant, labels zero outside fg, ``submission.h5`` written
     where h5py imports;
  13. ``scripts/main_torch.py`` with ``MONITOR.PROFILE_ITERS [2, 3]`` and a
     validation: the Chrome trace holds K1 and K2 kernel events and the
     validation panels are PNG files;
  14. the on-disk readers: CVPPP A1 and BBBC039 fixture trees written here
     by ``pctrans_torch.data.fixtures`` (the probe line says whether PIL
     and cv2 import); (a) ``scripts/scan_dataset_torch.py`` over both; (b)
     ``scripts/eval_torch.py`` with the published YAMLs and DATA_TYPE
     CVPPP / BBBC over phase 8's checkpoints (the CVPPP val split, the BBBC
     test split, then its validation split through ``Trainer.test_bbbc``;
     K1 = 6, K3 = 10, K4 = 1 per forward); (c) ``scripts/main_torch.py``
     with DATA_TYPE CVPPP, then BBBC, 2 iterations over the train split
     (cv2's augmentations) and a validation (K1 = K2 = 6 per step);
  15. the legacy U-Nets from ``build_architecture`` at its defaults:
     ``unet_3d`` and ``unet_plus_3d`` on [2, 1, 8, 256, 256], ``unet_2d``
     and ``unet_plus_2d`` on [2, 1, 256, 256], one f32 step each (the
     two-term ``LegacyCriterion``, backward, AdamW) in f32 on the card
     against an f64 CPU copy (losses and gradient norm within rel 1e-5),
     then ms per step
     (CUDA events) and peak GiB; no kernel of the repo runs there;
  16. the rest of the legacy zoo from ``build_architecture`` at its
     defaults with three output channels: ``fpn_3d`` over the resnet,
     repvgg, botnet and efficientnet backbones and ``unet_residual_3d`` on
     [2, 1, 8, 256, 256], ``deeplabv3a`` (with ``AUX_OUT``), ``v3b`` and
     ``v3c`` (ResNet-50 dilated to stride 8) on [2, 1, 256, 256]: one f32
     step each (the two-term affinity ``LegacyCriterion``) in f32 on the
     card against an f64 CPU copy within 1e-5 (DeepLab's gradient norm
     within 5e-4), ms per step, peak GiB and conv GFLOP; the repvgg FPN3D
     converted to deploy, its eval forward within 1e-5 of the train-mode
     model's; ``Discriminator3D`` on ``unet_residual_3d``'s output, one
     ``GANLoss`` step, f32 card against f64 CPU;
  17. an SNEMI3D-sized volume (100 x 1024 x 1024, 400 ids; image a u8 PNG
     stack through cv2, labels a u16 multi-page TIFF through PIL) read by
     ``get_dataset`` with DATA_TYPE volume, the default augmentor and
     3-channel affinity targets: samples/s over 32 draws, two draws from
     one seed equal, a seeded sample's checksum beside the one recorded
     under cv2 5.0 (printed, not gated), one ``fpn_3d`` step on two samples,
     the val grid, and a ``TileDataset`` over a two-tile JSON layout;
  then one JSON line of kernel results (each with its bound on the card
  and, where one PyTorch call computes the same function, that call's
  time), the card line and the final status line.

Synthetic scenes come from ``pctrans_torch.data.synthetic``; nothing here
or in ``pctrans_torch`` imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
BBBC_BATCH = 2                 # INFERENCE.SAMPLES_PER_BATCH of the BBBC recipe
BBBC_HW = (520, 696)           # a BBBC039 image
BBBC_TOP_K = 160               # INFERENCE.TOP_K of the BBBC recipe
BBBC_ENTRY_ITERS = 2           # iterations of the BBBC entry-point run
SAMPLED_STEPS = 3              # counted per point mode (phase 7b), after one warm-up
# MODEL.MASK_FORMER.TPU_RECIPE of the published PCTrans training estimator
# (pctrans_tpu/config/defaults.py:134-139), UPSAMPLE2X aside
REFERENCE_ESTIMATOR = dict(point_select="exact", candidate_ratio=3.0,
                           exact_targets=True, sample_dtype="float32")
# phase 8c's --opts: the reference estimator and the other SOLVER settings
SETTINGS_OPTS = ["MODEL.MASK_FORMER.TPU_RECIPE.POINT_SELECT", "exact",
                 "MODEL.MASK_FORMER.TPU_RECIPE.CANDIDATE_RATIO", "3.0",
                 "MODEL.MASK_FORMER.TPU_RECIPE.EXACT_TARGETS", "True",
                 "MODEL.MASK_FORMER.TPU_RECIPE.SAMPLE_DTYPE", "float32",
                 "MODEL.MASK_FORMER.TPU_RECIPE.UPSAMPLE2X", "True",
                 "SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR",
                 "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                 "SOLVER.SWA.ENABLED", "True", "SOLVER.SWA.START_ITER", "2",
                 "SOLVER.SWA.MERGE_ITER", "1", "SOLVER.SWA.BN_UPDATE_ITER", "2",
                 "DATASET.TRANSFER_UINT8", "True"]
CRITERION_RTOL = 1e-4          # each loss and the matched cost, card against CPU
# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes per second,
# f32 FLOP/s outside the tensor cores, dense TF32 FLOP/s on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_INT8_OP_PER_S = 1979e12


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


TRACE_TRIES = 8                # traces taken before a device time gives up


def trace_kernels(fn, reps: int, why_again) -> list:
    """The kernel events of ``reps`` calls of ``fn()`` in one
    ``torch.profiler`` trace.  A trace on the H100 can lose events, and now
    and then every trace taken within a fraction of a second holds
    none, so a trace for which ``why_again(events)`` gives a reason is
    taken again after a pause that doubles from 0.1 s.  After
    ``TRACE_TRIES`` such traces the one that kept the most events is used,
    and said so; only traces that all hold no event fail."""
    from torch.profiler import ProfilerActivity, profile

    fullest = []
    for attempt in range(TRACE_TRIES):
        if attempt:
            time.sleep(0.05 * 2 ** attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        why = why_again(events)
        if why is None:
            return events
        print(f"trace {attempt + 1} of at most {TRACE_TRIES} set aside: {why}")
        if sum(e.count for e in events) > sum(e.count for e in fullest):
            fullest = events
    if not fullest:
        raise AssertionError(f"{TRACE_TRIES} traces in a row held no device event")
    print(f"using the fullest of {TRACE_TRIES} traces: {why_again(fullest)}")
    return fullest


def device_ms(fn, reps: int = 10, kernel: str = "", launches: int = 0) -> float:
    """Device time per call of ``fn()``: the kernels' own time summed by
    ``torch.profiler``, host overhead excluded; with ``kernel``, only the
    kernels whose name contains it.  Each kernel's time is its mean over
    the events the trace kept times its launches per call, round(events /
    reps), or ``launches`` where the caller knows it.  A trace that lost
    more than one of a kernel's events and more than a quarter of them
    (a tenth where its launches per call are inferred and above one,
    which a larger loss could round down) is taken again
    (``trace_kernels``)."""

    def tally(events):
        events = [e for e in events if kernel in e.key]
        per_call = [launches or max(1, round(e.count / reps)) for e in events]
        lost = [n * reps - e.count for n, e in zip(per_call, events)]
        return events, per_call, lost

    def why_again(events):
        events, per_call, lost = tally(events)
        if not events:
            return f"it holds no device event of {kernel or 'the call'}"
        if all(0 <= k <= max(1, n * reps // (4 if launches or n == 1 else 10))
               for n, k in zip(per_call, lost)):
            return None
        return (f"it holds {sum(e.count for e in events)} device events of "
                f"{kernel or 'the call'} against {sum(per_call) * reps} expected")

    fn()
    torch.cuda.synchronize()
    events, per_call, lost = tally(trace_kernels(fn, reps, why_again))
    if sum(lost):
        print(f"device_ms: the trace lost {sum(lost)} of {sum(per_call) * reps} device "
              "events; each kernel's time is its mean over those kept")
    return sum(e.self_device_time_total / e.count * n
               for n, e in zip(per_call, events)) / 1e3


def timed(name: str, run, twin, **dev_kw) -> dict:
    """ms per call of ``run`` (a kernel's wrapper) and ``twin`` and their
    device ms; ``dev_kw`` goes to the kernel's ``device_ms``."""
    ms, plain = time_ms(run), time_ms(twin)
    dev_ms, dev_plain = device_ms(run, **dev_kw), device_ms(twin)
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


def scene_batches(n_batches: int, seed: int, batch: int = BATCH, hw=IMAGE_HW, **scene):
    """Batches of synthetic scenes; ``scene`` goes to ``make_blob_image``
    (the instance count and radii of nuclei scenes)."""
    from pctrans_torch.data.synthetic import make_blob_image

    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        items = [make_blob_image(rng, hw, **scene) for _ in range(batch)]
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


def time_on_model_inputs(name, kernel, twin, kernel_name, calls, tol) -> dict:
    """``kernel`` (K1 or K5's wrapper) on the (value, shapes, locations,
    weights) of ``calls``, the six encoder layers of one bf16 eval forward:
    each against ``twin``, then ms per launch (call and device) beside the
    twin's, and the bound on those inputs.  Device ms: ``kernel_name``'s
    launches alone."""
    n = len(calls)
    errs = [rel_fro(kernel(*c).float(), twin(*c).float()) for c in calls]
    print(f"{name} on the inputs of the bf16 eval forward's {n} encoder layers (value "
          f"{calls[0][0].dtype}, locations {calls[0][2].dtype}): rel-Fro to the twin "
          + " ".join(f"{e:.2e}" for e in errs) + f" (<= {tol:g})")
    if not max(errs) <= tol:
        raise AssertionError(f"{name} disagrees with its twin on the model's inputs")
    ms = time_ms(lambda: [kernel(*c) for c in calls]) / n
    plain = time_ms(lambda: [twin(*c) for c in calls]) / n
    dev_ms = device_ms(lambda: [kernel(*c) for c in calls], kernel=kernel_name,
                       launches=n) / n
    print(f"{name} on the model's inputs, per launch: kernel {ms:.4f} ms/call "
          f"({dev_ms:.4f} ms device), twin {plain:.4f} ms/call")
    work = [msdeform_work(*c) for c in calls]
    rec = bound(f"{name} on the model's inputs, per launch", sum(b for b, _ in work) / n,
                sum(f for _, f in work) / n, dev_ms)
    return {"model_ms": ms, "model_device_ms": dev_ms, "model_plain_ms": plain,
            "model_bound_ms": rec["bound_ms"]}


K5_BF16_TOL = 1e-4
K5_KERNEL = "msdeform_sep_kernel"
# K6 and its twin round the same f32 values to bf16 at three places (S, P,
# the output) after sums in other orders: their gap stays under half a bf16
# step at the output's scale (tests/test_torch_window_attn_cuda.py)
K6_TWIN_GAP = 2.0 ** -9
K6_KERNEL = "window_attn_kernel"


def window_attn_work(args, out):
    """(bytes, FLOP) of one K6 call: q, k, v and the f32 table read once,
    the output written once; the two products, 2 N^2 x 32 multiply-adds per
    window and head."""
    qkv, table, heads = args[0], args[1], args[2]
    windows, n = qkv.shape[0], qkv.shape[1]
    return nbytes(qkv, out) + table.numel() * 4, 4 * n * n * 32 * windows * heads


def gate_window_attention(name, calls) -> dict:
    """K6 on the arguments of ``calls``, the window attentions of one bf16
    eval forward: each against its twin (rel-Fro <= ``K6_TWIN_GAP``), then
    ms per launch (call and device) beside the twin's, and the bound on
    those inputs (bytes at HBM's rate or the products at the bf16 tensor
    cores' dense peak, the larger)."""
    from pctrans_torch.ops.window_attn import window_attention

    n = len(calls)
    outs = [window_attention(*a) for a in calls]
    twins = [window_attention(*a, impl="twin") for a in calls]
    errs = [rel_fro(o.float(), t.float()) for o, t in zip(outs, twins)]
    print(f"{name} on the inputs of the bf16 eval forward's {n} blocks (windows "
          + " ".join(f"{a[3]}" for a in calls) + "): rel-Fro to the twin "
          + " ".join(f"{e:.2e}" for e in errs) + f" (<= {K6_TWIN_GAP:g})")
    if not max(errs) <= K6_TWIN_GAP:
        raise AssertionError(f"{name} disagrees with its twin on the model's inputs")
    ms = time_ms(lambda: [window_attention(*a) for a in calls]) / n
    plain = time_ms(lambda: [window_attention(*a, impl="twin") for a in calls]) / n
    dev_ms = device_ms(lambda: [window_attention(*a) for a in calls], kernel=K6_KERNEL,
                       launches=n) / n
    print(f"{name} per launch: kernel {ms:.4f} ms/call ({dev_ms:.4f} ms device), "
          f"twin {plain:.4f} ms/call")
    work = [window_attn_work(a, o) for a, o in zip(calls, outs)]
    rec = bound(f"{name} per launch", sum(b for b, _ in work) / n,
                sum(f for _, f in work) / n, dev_ms, PEAK_BF16_FLOP_PER_S, "bf16")
    return {"max_abs_err": max(float((o.float() - t.float()).abs().max())
                               for o, t in zip(outs, twins)),
            "ms": ms, "plain_ms": plain, "device_ms": dev_ms, **rec, "library_ms": None,
            "max_rel_fro": max(errs)}


def check_separable(inputs) -> float:
    """K5 against its separable twin and against K1 on ``inputs``; returns
    the largest f32 absolute difference from the twin.  In bf16 K5 and its
    twin round hat_x to bf16 alike and sum in f32, so they differ by sum
    order and the output's bf16 rounding (one ULP where the two f32 sums
    straddle a rounding boundary): rel-Fro <= ``K5_BF16_TOL``.  K1 takes
    hat_x in f32, so K5 and K1 differ by that rounding too (<= 1e-2)."""
    from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_separable,
                                            ms_deform_attn_separable_twin)

    value, shapes, loc, w = inputs
    errs = {}
    for name, v in (("f32", value), ("bf16", value.bfloat16())):
        out = ms_deform_attn_separable(v, shapes, loc, w)
        torch.cuda.synchronize()
        twin = ms_deform_attn_separable_twin(v, shapes, loc, w)
        errs[name] = (rel_fro(out, twin),
                      rel_fro(out, ms_deform_attn(v, shapes, loc, w)),
                      int((out != twin).sum()))
        if name == "f32":
            worst = float((out - twin).abs().max())
    print(f"K5 ms_deform_attn_separable [B={value.shape[0]}, S=Lq={value.shape[1]}, "
          f"levels {shapes}]: rel-Fro against its twin / K1: f32 {errs['f32'][0]:.3e} / "
          f"{errs['f32'][1]:.3e} (<= 1e-5), bf16 {errs['bf16'][0]:.3e} (<= "
          f"{K5_BF16_TOL:g}; {errs['bf16'][2]} of {value.numel()} elements differ) / "
          f"{errs['bf16'][1]:.3e} (<= 1e-2)")
    if not (max(errs["f32"][:2]) <= 1e-5 and errs["bf16"][0] <= K5_BF16_TOL
            and errs["bf16"][1] <= 1e-2):
        raise AssertionError("K5 disagrees with its twin or with K1")
    return worst


def gate_separable(dev, g, inputs, k1):
    """K5 against its separable twin and against K1 on the K1 gate's inputs
    (timed beside both) and at phase 8's shapes: the 448x448 levels at the
    train batch and at the validation batch."""
    from pctrans_torch.ops.msdeform import (ms_deform_attn_separable,
                                            ms_deform_attn_separable_twin)

    worst = check_separable(inputs)
    for batch in (TRAIN_BATCH, BATCH):
        check_separable(msdeform_inputs(dev, g, batch, TRAIN_SHAPES))
    value, shapes, loc, w = inputs
    vb = value.bfloat16()
    # traces of K5 keep about 8 of 10 launches (see device_ms): the kernel
    # alone, at its known launch count
    times = timed("K5 bf16 value", lambda: ms_deform_attn_separable(vb, shapes, loc, w),
                  lambda: ms_deform_attn_separable_twin(vb, shapes, loc, w),
                  kernel=K5_KERNEL, launches=1)
    print(f"K5 beside K1 on the same inputs: K5 {times['ms']:.4f} ms/call "
          f"({times['device_ms']:.4f} device), K1 {k1['ms']:.4f} ms/call "
          f"({k1['device_ms']:.4f} device), K5/K1 device {times['device_ms'] / k1['device_ms']:.1f}x")
    return {"max_abs_err": worst, **times,
            **msdeform_bound("K5", vb, shapes, loc, w, times["device_ms"]),
            "library_ms": None}


def msdeform_backward_inputs(dev, g):
    """K2's gate inputs at the train shapes (batch 2, 448x448 levels): value,
    shapes, locations with a quarter of the samples on integral pixel
    coordinates, weights, and the output gradient."""
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
    gout = torch.randn(B, S, M * D, device=dev, generator=g)
    return value, shapes, loc, w.reshape(B, S, M, L, P), gout


def contention_locations(loc, shapes, g):
    """``loc`` with every sample of level 0 (the coarsest) moved into one
    2x2 block of cells per (batch, head): all queries of a head add into the
    same four corners there."""
    B, Lq, M, _, P, _ = loc.shape
    H, W = shapes[0]
    size = torch.tensor([W, H], dtype=torch.float32, device=loc.device)
    corner = torch.randint(1, min(H, W) - 2, (B, 1, M, 1, 2), device=loc.device,
                           generator=g)
    frac = torch.rand(B, Lq, M, P, 2, device=loc.device, generator=g)
    out = loc.clone()
    out[:, :, :, 0] = (corner + frac + 0.5) / size     # pixel coordinate in [c, c+1)
    return out


def msdeform_backward_work(value, shapes, loc, w, grad):
    """(bytes, FLOP) of one K2 call on these inputs: value, loc, w and grad
    read once; f32 d_value, d_loc and d_w written once; ~34 FLOP per inside
    sample and channel (the sample, the dot, two location terms, four
    d_value terms)."""
    n_bytes = nbytes(value, loc, w, grad) + 4 * (value.numel() + loc.numel() + w.numel())
    return n_bytes, msdeform_samples_inside(shapes, loc) * 34 * value.shape[3]


def check_msdeform_backward(name, value, shapes, loc, w, gout):
    """K2 through the autograd Function against the twin's autograd on these
    inputs, in f32 and bf16; returns the largest f32 absolute difference."""
    from pctrans_torch.ops.msdeform import ms_deform_attn

    def grads(v, impl):
        prim = [t.clone().requires_grad_() for t in (v, loc, w)]
        ms_deform_attn(prim[0], shapes, prim[1], prim[2], impl=impl).backward(
            gout.to(v.dtype))
        return [p.grad for p in prim]

    errs, worst = {}, 0.0
    for dt, v in (("f32", value), ("bf16", value.bfloat16())):
        ours = grads(v, None)
        torch.cuda.synchronize()
        ref = grads(v, "twin")
        errs[dt] = [rel_fro(a, b) for a, b in zip(ours, ref)]
        if dt == "f32":
            worst = max(float((a - b).abs().max()) for a, b in zip(ours, ref))
    B, S, M, D = value.shape
    print(f"K2 ms_deform_attn backward, {name} [B={B}, S=Lq={S}, M={M}, D={D}]: "
          "rel-Fro of d_value, d_loc, d_w: f32 "
          + " ".join(f"{e:.3e}" for e in errs["f32"]) + " (<= 1e-5), bf16 "
          + " ".join(f"{e:.3e}" for e in errs["bf16"]) + " (<= 1e-2)")
    if not (max(errs["f32"]) <= 1e-5 and max(errs["bf16"]) <= 1e-2):
        raise AssertionError(f"K2 disagrees with the twin's autograd ({name})")
    return worst


def gate_msdeform_backward(dev, g):
    """K2 through the autograd Function against the twin's autograd at the
    train shapes, on random locations (a quarter on integral pixel
    coordinates, where both take the hat derivative 0) and on the
    contention case (every query of a head in the same 2x2 cells of the
    14x14 level).  Then K2 alone on both and K1 alone at those shapes, each
    beside its twin, and the two together under autograd.  Returns K2's
    record and K1's train-shape times."""
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward

    value, shapes, loc, w, gout = msdeform_backward_inputs(dev, g)
    loc_c = contention_locations(loc, shapes, g)
    worst = check_msdeform_backward("random locations, 25% integral", value, shapes,
                                    loc, w, gout)
    check_msdeform_backward("contention on the 14x14 level", value, shapes, loc_c,
                            w, gout)

    vb, gb = value.bfloat16(), gout.bfloat16()
    # K2 alone: its wrapper (the zeroed f32 d_value, the kernel, the casts
    # of the results) beside the twin's autograd
    k2 = timed("K2 ms_deform_attn_backward alone, bf16 value",
               lambda: ms_deform_attn_backward(vb, shapes, loc, w, gb),
               lambda: ms_deform_attn_backward(vb, shapes, loc, w, gb, impl="twin"))
    k2_kernel = device_ms(lambda: ms_deform_attn_backward(vb, shapes, loc, w, gb),
                          kernel="msdeform_bwd_kernel")
    print(f"K2 msdeform_bwd_kernel alone: {k2_kernel:.4f} ms device")
    k2_rec = {"max_abs_err": worst, **k2, "kernel_device_ms": k2_kernel,
              **bound("K2", *msdeform_backward_work(vb, shapes, loc, w, gb),
                      k2["device_ms"]),
              "library_ms": None}
    cont = device_ms(lambda: ms_deform_attn_backward(vb, shapes, loc_c, w, gb),
                     kernel="msdeform_bwd_kernel")
    print(f"K2 msdeform_bwd_kernel alone, contention case: {cont:.4f} ms device")
    k2_rec.update(contention_kernel_device_ms=cont, contention_bound_ms=bound(
        "K2, contention case", *msdeform_backward_work(vb, shapes, loc_c, w, gb),
        cont)["bound_ms"])
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


def time_k2_on_model_inputs(calls) -> dict:
    """K2 on the (value, shapes, locations, weights, output gradient) of
    ``calls``, the six encoder layers of one bf16 train step: each against
    the twin's autograd, then ms per launch (call, device, the kernel alone)
    beside the twin's, and the bound on those inputs."""
    from pctrans_torch.ops.msdeform import ms_deform_attn_backward

    n = len(calls)
    errs = {"bf16": [], "f32": []}
    for c in calls:
        v, shapes, loc, w, grad = c
        for dt, args in (("bf16", c), ("f32", (v.float(), shapes, loc, w, grad.float()))):
            ours = ms_deform_attn_backward(*args)
            torch.cuda.synchronize()
            errs[dt].append(max(rel_fro(a.float(), b.float()) for a, b in
                                zip(ours, ms_deform_attn_backward(*args, impl="twin"))))
    print(f"K2 on the inputs of one bf16 train step's {n} encoder layers (value "
          f"{calls[0][0].dtype}, grad {calls[0][4].dtype}): largest rel-Fro of d_value, "
          "d_loc, d_w to the twin's autograd per layer, bf16 "
          + " ".join(f"{e:.2e}" for e in errs["bf16"]) + " (<= 1e-2), the same in f32 "
          + " ".join(f"{e:.2e}" for e in errs["f32"]) + " (<= 1e-5)")
    if not (max(errs["bf16"]) <= 1e-2 and max(errs["f32"]) <= 1e-5):
        raise AssertionError("K2 disagrees with the twin's autograd on the model's inputs")
    run = lambda: [ms_deform_attn_backward(*c) for c in calls]
    ms = time_ms(run) / n
    plain = time_ms(lambda: [ms_deform_attn_backward(*c, impl="twin") for c in calls]) / n
    dev_ms = device_ms(run) / n
    kernel_ms = device_ms(run, kernel="msdeform_bwd_kernel") / n
    print(f"K2 on the model's inputs, per launch: {ms:.4f} ms/call ({dev_ms:.4f} ms "
          f"device, the kernel {kernel_ms:.4f}), twin {plain:.4f} ms/call")
    work = [msdeform_backward_work(*c) for c in calls]
    rec = bound("K2 on the model's inputs, per launch", sum(b for b, _ in work) / n,
                sum(f for _, f in work) / n, dev_ms)
    return {"model_ms": ms, "model_device_ms": dev_ms, "model_kernel_device_ms": kernel_ms,
            "model_plain_ms": plain, "model_bound_ms": rec["bound_ms"]}


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


# K4's cases: (key prefix, batch, masks, output size, threshold): the CVPPP
# eval's top-50 and full-Q re-run at 530x500, the BBBC eval's full-Q re-run
# (Q=300) at 520x696
K4_CASES = [("", BATCH, 50, IMAGE_HW, 0.69), ("k100_", BATCH, 100, IMAGE_HW, 0.69),
            ("bbbc_k300_", BBBC_BATCH, 300, BBBC_HW, 0.05)]


def gate_resize_binarize(dev, g):
    """K4 against its twin on the stride-4 logits [B, K, h, w] of each case
    in ``K4_CASES``: at most 1e-4 of the bits flipped, each within 1e-4 of
    the threshold; then each timed beside the twin and the two-call PyTorch
    yardstick.  One record, the later cases under their key prefixes."""
    from pctrans_torch.ops.resize import resize_bilinear
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    rec = {}
    for prefix, B, K, hw, t in K4_CASES:
        logit_t = math.log(t / (1 - t))
        x = torch.randn(B, K, *stage_sizes(hw)[0], device=dev, generator=g) * 3.0
        out = resize_bilinear_binarize(x, hw, logit_t)
        torch.cuda.synchronize()
        twin = resize_bilinear_binarize(x, hw, logit_t, impl="twin")
        logits = resize_bilinear(x, hw)
        flips = out != twin
        n_flips = int(flips.sum())
        worst = float((logits[flips] - logit_t).abs().max()) if n_flips else 0.0
        frac = n_flips / out.numel()
        name = f"K4 [B={B}, K={K}, {tuple(x.shape[2:])} -> {hw}, t={t}]"
        print(f"{name}: {n_flips} flipped of {out.numel()} ({frac:.2e}; <= 1e-4), "
              f"largest |logit - t| at a flip {worst:.3e} (<= 1e-4)")
        if not (frac <= 1e-4 and worst <= 1e-4):
            raise AssertionError(f"{name} disagrees with its twin")
        del logits
        times = timed(name, lambda: resize_bilinear_binarize(x, hw, logit_t),
                      lambda: resize_bilinear_binarize(x, hw, logit_t, impl="twin"))
        # yardstick of two PyTorch calls (no single call binarizes): upsample
        # with F.interpolate, then compare
        library = time_ms(lambda: torch.nn.functional.interpolate(
            x, hw, mode="bilinear", align_corners=False) > logit_t)
        print(f"{name} yardstick, F.interpolate(bilinear) > t: {library:.4f} ms/call")
        # two lerps along each axis and a compare, ~10 FLOP per output pixel
        r = {"max_abs_err": float((out.int() - twin.int()).abs().max()), **times,
             **bound(name, nbytes(x, out), 10 * out.numel(), times["device_ms"]),
             "library_ms": library}
        rec.update({f"{prefix}{k}": v for k, v in r.items()
                    if not (prefix and k == "bound_by")})
        del x, out, twin
    return rec


# K7's cases: (key prefix, batch, masks, image size): the eval path's
# statistics of CVPPP's top 50 and full-Q 100 masks at 530x500 and BBBC's
# top 160 and full-Q 300 at 520x696
K7_CASES = [("", BATCH, 50, IMAGE_HW), ("k100_", BATCH, 100, IMAGE_HW),
            ("bbbc_k160_", BBBC_BATCH, BBBC_TOP_K, BBBC_HW),
            ("bbbc_k300_", BBBC_BATCH, 300, BBBC_HW)]


def bf16_gram_f32(h: torch.Tensor) -> torch.Tensor:
    """One PyTorch call: the bf16 product h h^T with an f32 output (counts
    above 256 would round in a bf16 one)."""
    return torch.bmm(h, h.transpose(1, 2), out_dtype=torch.float32)


def gate_mask_stats(dev, g):
    """K7 against its twin (the f32 ``bmm`` of the cast masks, TF32 off) on
    0/1 masks of a density of their own each, with a peak column, at each
    case of ``K7_CASES``: bit-equal, or fail; then each timed beside the
    twin, its bound the larger of the u8 masks' bytes at 3.35 TB/s and the
    i <= j pairs' u8 operations at 1,979 TOPS, and two PyTorch calls as
    yardsticks: the f32 ``bmm`` of masks already cast (``library_ms``) and
    a bf16 one with an f32 output (``bf16_library_ms``).  One record, the
    later cases under their key prefixes."""
    from pctrans_torch.ops.mask_stats import packed_mask_stats

    rec = {}
    for prefix, B, K, hw in K7_CASES:
        density = torch.rand(1, K, 1, 1, device=dev, generator=g)
        masks = (torch.rand(B, K, *hw, device=dev, generator=g) < density).to(torch.uint8)
        peaks = torch.randn(B, K, device=dev, generator=g)
        out = packed_mask_stats(masks, peaks)
        torch.cuda.synchronize()
        twin = packed_mask_stats(masks, peaks, impl="twin")
        name = f"K7 [B={B}, K={K}, {hw}]"
        err = float((out - twin).abs().max())
        print(f"{name}: largest |K7 - twin| {err} over {out.numel()} statistics "
              "(bit-equal required)")
        if not torch.equal(out, twin):
            raise AssertionError(f"{name} differs from its twin")
        times = timed(name, lambda: packed_mask_stats(masks, peaks),
                      lambda: packed_mask_stats(masks, peaks, impl="twin"))
        f = masks.reshape(B, K, -1).float()
        library = time_ms(lambda: torch.bmm(f, f.transpose(1, 2)))
        del f
        h = masks.reshape(B, K, -1).bfloat16()
        bf16_library = time_ms(lambda: bf16_gram_f32(h))
        del h
        print(f"{name} yardsticks: f32 bmm of the cast masks {library:.4f} ms/call, bf16 "
              f"bmm with an f32 output {bf16_library:.4f} ms/call")
        # a multiply and an add per pixel of each pair i <= j
        ops = B * hw[0] * hw[1] * K * (K + 1)
        r = {"max_abs_err": err, **times,
             **bound(name, nbytes(masks, peaks, out), ops, times["device_ms"],
                     PEAK_INT8_OP_PER_S, "u8"),
             "library_ms": library, "bf16_library_ms": bf16_library}
        rec.update({f"{prefix}{k}": v for k, v in r.items()
                    if not (prefix and k == "bound_by")})
        del masks, out, twin
    return rec


# (prefix, B, H x W, largest GT id, largest predicted id, ground-truth dtype,
# with CVPPP's foreground): BBBC's and CVPPP's eval batches, then an odd
# width and a misaligned start
K8_CASES = [("", BBBC_BATCH, BBBC_HW, 148, 300, torch.int32, False),
            ("cvppp_", BATCH, IMAGE_HW, 12, 100, torch.int32, True),
            ("odd_", 3, (67, 63), 20, 50, torch.int16, True),
            ("misaligned_", 2, (53, 61), 9, 30, torch.uint16, False)]


def label_pairs_inputs(dev, g, B, hw, max_gt, max_pred, gt_dtype, with_fg, offset):
    """Blocky label maps (runs of equal ids, as painted maps have) and ground
    truth on the card; ``offset`` elements into a larger buffer, so that
    every base address is misaligned."""
    def blocks(n_ids, block, dtype):
        h, w = -(-hw[0] // block), -(-hw[1] // block)
        small = torch.randint(0, n_ids + 1, (B, h, w), device=dev, generator=g)
        full = small.repeat_interleave(block, 1).repeat_interleave(block, 2)
        full = full[:, :hw[0], :hw[1]].to(dtype).reshape(-1)
        buf = torch.empty(full.numel() + offset, dtype=dtype, device=dev)
        buf[offset:] = full
        return buf[offset:].view(B, *hw)

    labels = blocks(max_pred, 7, torch.int16)
    gt = blocks(max_gt, 11, gt_dtype)
    fg = blocks(1, 5, torch.uint8) if with_fg else None
    return labels, gt, fg


def gate_label_pairs(dev, g):
    """K8 against its twin (``torch.bincount`` of the keys) at each case of
    ``K8_CASES``: bit-equal, or fail; then timed beside the twin at the two
    eval shapes, its bound the bytes of the maps read once and the table
    written once at 3.35 TB/s.  One record, the later cases under their key
    prefixes."""
    from pctrans_torch.ops.label_pairs import label_pairs

    rec = {}
    for prefix, B, hw, max_gt, max_pred, gt_dtype, with_fg in K8_CASES:
        labels, gt, fg = label_pairs_inputs(dev, g, B, hw, max_gt, max_pred, gt_dtype,
                                            with_fg, 1 if prefix == "misaligned_" else 0)
        out = label_pairs(labels, gt, max_gt, max_pred, fg)
        torch.cuda.synchronize()
        twin = label_pairs(labels, gt, max_gt, max_pred, fg, impl="twin")
        name = f"K8 [B={B}, {hw}, G={max_gt}, C={max_pred}, {gt_dtype}, fg {with_fg}]"
        err = int((out - twin).abs().max())
        print(f"{name}: largest |K8 - twin| {err} over {out.numel()} counts, each image "
              f"{out.sum(dim=(1, 2)).tolist()} of {hw[0] * hw[1]} pixels (bit-equal required)")
        if not torch.equal(out, twin) or (out.sum(dim=(1, 2)) != hw[0] * hw[1]).any():
            raise AssertionError(f"{name} differs from its twin")
        r = {"max_abs_err": float(err), "library_ms": None}
        if prefix in ("", "cvppp_"):
            r.update(timed(name, lambda: label_pairs(labels, gt, max_gt, max_pred, fg),
                           lambda: label_pairs(labels, gt, max_gt, max_pred, fg,
                                               impl="twin")))
            r.update(bound(name, nbytes(labels, gt, out, *(() if fg is None else (fg,))),
                           0.0, r["device_ms"]))
        rec.update({f"{prefix}{k}": v for k, v in r.items()
                    if not (prefix and k in ("bound_by", "library_ms"))})
        del labels, gt, fg, out, twin
    return rec


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


def slice_f32(dev, config=None, name="f32 slice"):
    """The f32 forward of ``config`` (by default the CVPPP recipe) through
    the kernels and through the twins on one batch of four 530x500 scenes:
    each mask prediction within rel-Fro 1e-3 up to the first
    attention-mask flip."""
    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.ops import _build

    config = config or CVPPP_RECIPE
    model = build_model(dataclasses.replace(config, dtype="float32"), dev)
    batch = next(scene_batches(1, SEED))
    x = torch.from_numpy(batch["image"]).to(dev)
    with torch.inference_mode():
        out = model(x)
        with _build.twins():
            ref = model(x)
    masks_out = out["aux_masks"] + [out["pred_masks"]]
    masks_ref = ref["aux_masks"] + [ref["pred_masks"]]
    errs = [rel_fro(a.float(), b.float()) for a, b in zip(masks_out, masks_ref)]
    # The forward is discontinuous at the attention-mask threshold
    # (sigmoid < 0.5): mask j's bits steer decoder layer j, so a bit flipped
    # by summation order lets the two runs part from layer j on.  Gate every
    # mask up to and including the first one with a flip (all of them,
    # pred_masks included, when none flips).  The DETR predictor masks no
    # attention.
    flips = (attn_mask_flips(masks_out, masks_ref, IMAGE_HW) if "reference_points" in out
             else [0] * (len(errs) - 1))
    n_gated = next((j for j, f in enumerate(flips) if f), len(errs) - 1) + 1
    print(f"{name}, kernels vs twins, rel-Fro per mask prediction "
          f"{tuple(out['pred_masks'].shape)}: "
          + " ".join(f"{e:.2e}" for e in errs)
          + "; attention-mask bits flipped per layer: "
          + " ".join(map(str, flips))
          + f"; gated (<= 1e-3): the first {n_gated} of {len(errs)}")
    if not all(torch.isfinite(t).all() for t in (out["pred_masks"], ref["pred_masks"])):
        raise AssertionError(f"{name}: non-finite f32 mask logits")
    if not max(errs[:n_gated]) <= 1e-3:
        raise AssertionError(f"{name}: masks rel-Fro {max(errs[:n_gated]):.3e} "
                             "> 1e-3 before the first attention-mask flip")


def host_fetches(fn):
    """``fn()`` and the (shape, bytes) of every CUDA tensor it copied to the
    host through ``Tensor.cpu``, the evaluator's one way to fetch."""
    fetched = []
    cpu = torch.Tensor.cpu

    def record(t, *args, **kwargs):
        if t.is_cuda:
            fetched.append((tuple(t.shape), t.numel() * t.element_size()))
        return cpu(t, *args, **kwargs)

    torch.Tensor.cpu = record
    try:
        return fn(), fetched
    finally:
        torch.Tensor.cpu = cpu


def bbbc_exact_order_oracle(masks):
    """``instance_inference_bbbc`` on one image's u8 masks [K, H, W] with the
    device postprocess's paint order: clusters sorted by their exact
    rational area (the sum of member areas over n, in f64) where the numpy
    oracle sorts the f32 sums of the merged masks' H*W values, the one
    documented difference (``device_postprocess.py``).  Returns (label map,
    the cluster pairs (i, j, exact_i, exact_j, f32_i, f32_j) that the two
    keys order otherwise)."""
    from pctrans_torch.inference.postprocess import clusters_from_dice, pairwise_dice_binary

    pred = masks.astype(np.float32)
    areas = pred.reshape(len(pred), -1).sum(axis=1)
    pred, areas = pred[areas > 40], areas[areas > 40]
    if not len(pred):
        return np.zeros(masks.shape[1:], np.int16), []
    clusters = clusters_from_dice(pairwise_dice_binary(pred), 0.15)
    merged = np.stack([pred[m].mean(axis=0) for m in clusters])
    exact = np.array([areas[m].astype(np.float64).sum() / len(m) for m in clusters])
    f32 = merged.reshape(len(merged), -1).sum(axis=1)
    stack = np.concatenate([np.zeros((1,) + merged.shape[1:], merged.dtype),
                            merged[np.argsort(exact, kind="stable")]])
    swaps = [(i, j, exact[i], exact[j], f32[i], f32[j])
             for i in range(len(clusters)) for j in range(i + 1, len(clusters))
             if np.sign(exact[i] - exact[j]) != np.sign(f32[i] - f32[j])]
    return np.argmax(stack, axis=0).astype(np.int16), swaps


def check_labels(name, ev, batches, oracle) -> dict:
    """The device postprocess against the numpy ``oracle`` on batch 0's u8
    masks (label maps equal, or fail; for BBBC, where the paint order is the
    one documented difference, equal to ``bbbc_exact_order_oracle`` and the
    pixels that differ from the oracle explained by the pairs of clusters
    whose two area keys order otherwise), its ms per batch (the host-fetched
    statistics to the label map on the host) over every batch, and the
    host fetches of one ``predict_labels``: the statistics and the label
    map, never the mask stack."""
    post_ms = []
    for i, batch in enumerate(batches):
        masks, stats = ev.masks_and_stats(batch["image"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = ev.label_masks(masks, stats)
        post_ms.append((time.perf_counter() - t0) * 1e3)
        if i:
            continue
        host = masks.cpu().numpy()
        t0 = time.perf_counter()
        ref = np.stack([oracle(m.astype(np.float32), ev.threshold) for m in host])
        oracle_ms = (time.perf_counter() - t0) * 1e3
        differ = [int((a != b).sum()) for a, b in zip(labels, ref)]
        print(f"{name}: batch 0's label maps (masks {tuple(host.shape)}) against the numpy "
              f"oracle: pixels that differ per image {differ}; instances per image "
              + " ".join(str(int(l.max())) for l in labels))
        if ev.postprocessor.dataset == "bbbc":
            for b, (lab, m) in enumerate(zip(labels, host)):
                exact, swaps = bbbc_exact_order_oracle(m)
                n_exact = int((lab != exact).sum())
                print(f"{name} image {b}: {n_exact} pixels differ from the oracle with the "
                      f"exact-area paint order; {len(swaps)} cluster pairs order otherwise "
                      "by the exact area than by numpy's f32 sum (i, j, exact, exact, f32, "
                      f"f32): {swaps}")
                if n_exact or (differ[b] and not swaps):
                    raise AssertionError(f"{name}: the device postprocess's labels differ "
                                         "from the numpy oracle's beyond the paint order")
        elif any(differ):
            raise AssertionError(f"{name}: the device postprocess's labels differ "
                                 "from the numpy oracle's")
    labels, fetched = host_fetches(lambda: ev.predict_labels(batches[0]["image"]))
    mask_bytes = host.size
    print(f"{name}: host fetches of one predict_labels: "
          + ", ".join(f"{shape} ({n} B)" for shape, n in fetched)
          + f"; {sum(n for _, n in fetched)} B in all, against {mask_bytes} B of u8 masks")
    if any(len(shape) == 4 for shape, _ in fetched):
        raise AssertionError(f"{name}: predict_labels fetched a mask stack")
    print(f"{name}: device postprocess {statistics.mean(post_ms):.3f} ms per batch (host-fetched "
          "statistics to the label map on the host; per batch "
          + " ".join(f"{t:.2f}" for t in post_ms)
          + f"), numpy oracle {oracle_ms:.1f} ms on batch 0")
    return {"post_ms": post_ms, "oracle_ms": oracle_ms}


def eval_run(name, ev, batches, score, layers):
    """``score(batches)`` (the evaluator's protocol) with the launch
    counters set to 0 just before and read just after: K1, K3 and K4 must
    run ``layers`` = (encoder layers, decoder layers + 1, 1) times per
    forward, re-runs included, and K6 none, or, where ``layers`` has a
    fourth entry (a Swin backbone's blocks), that many times per forward;
    K7 once per forward and, in the CVPPP protocol, once per batch for the
    merged masks; K8 once per batch.  Returns (launches: those of
    ``layers``, then K7's and K8's, forwards, wall s, metrics)."""
    from pctrans_torch.ops.label_pairs import label_pairs
    from pctrans_torch.ops.mask_stats import packed_mask_stats
    from pctrans_torch.ops.msdeform import ms_deform_attn
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize
    from pctrans_torch.ops.window_attn import window_attention

    ev.predict_labels(batches[0]["image"])            # warm-up, not counted
    torch.cuda.synchronize()
    counters = (ms_deform_attn, dynamic_mask_render, resize_bilinear_binarize,
                window_attention, packed_mask_stats, label_pairs)
    for fn in counters:
        fn.launches = 0
    ev.forwards = 0
    t0 = time.perf_counter()
    res = score(batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    fwd = ev.forwards
    k7 = fwd + (len(batches) if ev.postprocessor.dataset == "cvppp" else 0)
    n_img = sum(b["image"].shape[0] for b in batches)
    print(f"{name} over {len(batches)} batches: {fwd} forwards ({fwd - len(batches)} "
          f"full-Q re-runs); launches K1 {launches[0]}, K3 {launches[1]}, K4 {launches[2]}, "
          f"K6 {launches[3]}, K7 {launches[4]}, K8 {launches[5]}; end to end "
          f"{n_img / wall:.3f} img/s ({wall:.3f} s wall for {n_img} images)")
    if fwd < len(batches) or launches != ([n * fwd for n in (*layers, 0)[:4]]
                                          + [k7, len(batches)]):
        raise AssertionError(f"{name}: launch counts do not match the forwards run")
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"{name}: non-finite metrics {res}")
    return launches[:len(layers)] + launches[4:], fwd, wall, res


def forward_times(model, x):
    """The forward's ms per batch (CUDA events) and its device ms."""
    with torch.inference_mode():
        return (time_ms(lambda: model(x), warmup=2, reps=5),
                device_ms(lambda: model(x), reps=5))


def slice_bf16(dev, card, config=None, name="bf16 CVPPP", with_k5=True):
    """The bf16 recipe (or ``config``) as served: the evaluator over three
    batches of four 530x500 scenes, batch 0's labels against the numpy
    oracle, the forward's times, K1 gated and timed on the inputs one
    forward gives it and, ``with_k5``, K5 on the same inputs; with a Swin
    backbone, K6 counted (one per
    block and forward) and gated and timed on the window attentions of one
    forward.  Returns (launches (``eval_run``'s: K7's last), K1's record,
    K5's, K6's)."""
    import pctrans_torch.models.pixel_decoder as pixel_decoder
    import pctrans_torch.models.swin as swin
    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.engine.evaluator import Evaluator
    from pctrans_torch.inference.postprocess import instance_inference_cvppp
    from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_separable,
                                            ms_deform_attn_separable_twin)

    c = config or CVPPP_RECIPE
    with_k6 = c.backbone_name == "D2SwinTransformer"
    model = build_model(c, dev)
    ev = Evaluator(model, top_k=50)
    batches = list(scene_batches(N_EVAL_BATCHES, SEED + 1))
    launches, fwd, wall, res = eval_run(
        f"{name} eval, batch {BATCH}, {IMAGE_HW}", ev, batches, ev.eval_cvppp,
        (c.enc_layers, c.dec_layers + 1, 1) + ((sum(c.swin_depths),) if with_k6 else ()))
    print(f"SBD {res['SBD']:.4f}, |DiC| {res['absDiffFG']:.4f} "
          "(random weights: shows only that the chain ran)")
    check_labels(name, ev, batches, instance_inference_cvppp)
    x = torch.from_numpy(batches[0]["image"]).to(dev)
    k1_calls, k6_calls = [], []

    def keep_k1_inputs(value, shapes, loc, w):
        k1_calls.append((value, tuple(shapes), loc, w))
        return ms_deform_attn(value, shapes, loc, w)

    window_attention = swin.window_attention

    def keep_k6_inputs(*args):
        k6_calls.append(args)
        return window_attention(*args)

    with torch.inference_mode():
        pixel_decoder.ms_deform_attn = keep_k1_inputs
        swin.window_attention = keep_k6_inputs
        try:
            out = model(x)
        finally:
            pixel_decoder.ms_deform_attn = ms_deform_attn
            swin.window_attention = window_attention
        if len(k1_calls) != c.enc_layers:
            raise AssertionError(f"{len(k1_calls)} ms-deform calls in one forward")
        if len(k6_calls) != (sum(c.swin_depths) if with_k6 else 0):
            raise AssertionError(f"{len(k6_calls)} window-attention calls in one forward")
        for k in ("pred_masks", "reference_points", "query_emb", "sem_mask",
                  "mask_features"):
            if not torch.isfinite(out[k].float()).all():
                raise AssertionError(f"non-finite {k}")
        if tuple(out["pred_masks"].shape) != (BATCH, c.num_queries,
                                               *stage_sizes(IMAGE_HW)[0]):
            raise AssertionError(f"pred_masks shape {tuple(out['pred_masks'].shape)}")
        fwd_ms, fwd_dev = forward_times(model, x)
        k1_model = time_on_model_inputs(
            f"K1 ({name})", ms_deform_attn, lambda *a: ms_deform_attn(*a, impl="twin"),
            "msdeform_fwd_kernel", k1_calls, 1e-2)
        k5_model = (time_on_model_inputs("K5", ms_deform_attn_separable,
                                         ms_deform_attn_separable_twin, K5_KERNEL,
                                         k1_calls, K5_BF16_TOL) if with_k5 else None)
        k6_model = gate_window_attention(f"K6 ({name})", k6_calls) if with_k6 else None
    print(f"{name} forward {fwd_ms:.3f} ms/batch of {BATCH} (CUDA events), "
          f"{fwd_dev:.3f} ms of it device time ({1 - fwd_dev / fwd_ms:.1%} "
          f"idle); end to end {N_EVAL_BATCHES * BATCH / wall:.3f} img/s "
          f"({wall:.3f} s wall for {N_EVAL_BATCHES * BATCH} images, {fwd} forwards, "
          f"device postprocess included) on {card}")
    return launches, k1_model, k5_model, k6_model


def slice_bbbc(dev, card):
    """The BBBC recipe as served: ``Evaluator(dataset="bbbc", top_k=160)``
    with the full-width recipe (Q=300, bf16, seeded random weights) over
    batches of two 520x696 nuclei scenes (``synthetic_bbbc``'s rule at that
    size).  Random weights put nearly every query above the 0.05 threshold,
    so every batch runs again at full Q (K=300), and clustering at 0.15
    folds most masks together: the worst case for the statistics and the
    paint."""
    from pctrans_torch.config import BBBC_RECIPE
    from pctrans_torch.data.synthetic import nuclei_scene_rule
    from pctrans_torch.engine.evaluator import Evaluator
    from pctrans_torch.inference.postprocess import instance_inference_bbbc

    n_inst, radius = nuclei_scene_rule(BBBC_HW)
    batches = list(scene_batches(N_EVAL_BATCHES, SEED + 3, BBBC_BATCH, BBBC_HW,
                                 n_instances=n_inst, radius_px=radius))
    print(f"BBBC scenes {BBBC_HW}: {n_inst[0]}-{n_inst[1]} nuclei of radius {radius[0]}-"
          f"{radius[1]} px; instances per image "
          + " ".join(str(int(l.max())) for b in batches for l in b["label"]))
    model = build_model(BBBC_RECIPE, dev)
    ev = Evaluator(model, top_k=BBBC_TOP_K, dataset="bbbc")
    c = BBBC_RECIPE
    launches, fwd, wall, res = eval_run(
        f"bf16 BBBC eval (Q={c.num_queries}, TOP_K {BBBC_TOP_K}), batch {BBBC_BATCH}, "
        f"{BBBC_HW}", ev, batches, ev.test_bbbc, (c.enc_layers, c.dec_layers + 1, 1))
    print("BBBC metrics " + ", ".join(f"{k} {v:.4f}" for k, v in res.items())
          + (" (random weights: shows only that the chain ran; every batch re-ran at full Q, "
             "K=300, the worst case for the statistics and the paint)"
             if fwd == 2 * len(batches) else ""))
    post = check_labels("BBBC", ev, batches, instance_inference_bbbc)
    x = torch.from_numpy(batches[0]["image"]).to(dev)
    fwd_ms, fwd_dev = forward_times(model, x)
    print(f"bf16 BBBC forward {fwd_ms:.3f} ms/batch of {BBBC_BATCH} (CUDA events), "
          f"{fwd_dev:.3f} ms of it device time ({1 - fwd_dev / fwd_ms:.1%} idle); end to "
          f"end {len(batches) * BBBC_BATCH / wall:.3f} img/s ({fwd} forwards, device "
          f"postprocess {statistics.mean(post['post_ms']):.3f} ms per batch) on {card}")
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
    from pctrans_torch.ops import _build

    model = build_model(dataclasses.replace(CVPPP_RECIPE, dtype="float32"), dev)
    model.train()
    batch = next(scene_batches(1, SEED, TRAIN_BATCH, TRAIN_HW))
    x = torch.from_numpy(batch["image"]).to(dev)
    targets = targets_from_labels(torch.from_numpy(batch["label"]).to(dev).int(),
                                  MAX_INSTANCES)
    crit = SetCriterion(CVPPP_CRITERION)

    def grads(twins):
        model.zero_grad(set_to_none=True)
        with _build.twins() if twins else contextlib.nullcontext():
            out = model(x)
        loss = (crit.sem_loss(out["sem_mask"], targets["fg_mask"])
                + discriminative_loss(out["mask_features"], targets["seg"],
                                      MAX_INSTANCES))
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in
                                      model.pixel_decoder.named_parameters()}

    loss_k, ours = grads(False)
    loss_t, ref = grads(True)
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


def train_bf16(dev, card, config=None, n_steps=N_TRAIN_STEPS, name="bf16 train"):
    """The bf16 recipe (or ``config``) as trained: ``make_train_step`` with
    AdamW and WarmupPolyLR, one warm-up step then ``n_steps`` counted ones
    on batches of two 448x448 scenes, with launch counters (K1 = K2 = 6 per
    step, K3 = 0); then K2 gated and timed on the inputs the warm-up step
    gave it.  Returns (launches, K2's record)."""
    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.engine.solver import (CVPPP_SOLVER, build_lr_scheduler,
                                             build_optimizer)
    from pctrans_torch.engine.train_step import make_train_step
    from pctrans_torch.losses.criterion import SetCriterion, CVPPP_CRITERION
    from pctrans_torch.ops.msdeform import (MSDeformAttnFunction, ms_deform_attn,
                                            ms_deform_attn_backward)
    from pctrans_torch.ops.render import dynamic_mask_render

    c = config or CVPPP_RECIPE
    model = build_model(c, dev)
    opt = build_optimizer(model, CVPPP_SOLVER)
    step = make_train_step(model, SetCriterion(CVPPP_CRITERION), opt,
                           build_lr_scheduler(opt, CVPPP_SOLVER), MAX_INSTANCES,
                           torch.Generator(device=dev).manual_seed(SEED))
    batches = list(scene_batches(n_steps + 3, SEED + 2, TRAIN_BATCH, TRAIN_HW))
    # the warm-up step, not counted, keeps the inputs it passes to K2
    k2_calls = []
    backward = MSDeformAttnFunction.backward

    def keep_k2_inputs(ctx, grad_out):
        value, loc, w = ctx.saved_tensors
        k2_calls.append((value.detach(), ctx.spatial_shapes, loc.detach(), w.detach(),
                         grad_out.detach()))
        return backward(ctx, grad_out)

    MSDeformAttnFunction.backward = staticmethod(keep_k2_inputs)
    try:
        step(batches[0])
    finally:
        MSDeformAttnFunction.backward = staticmethod(backward)
    torch.cuda.synchronize()
    if len(k2_calls) != c.enc_layers:
        raise AssertionError(f"{len(k2_calls)} ms-deform backward calls in one step")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    counters = (ms_deform_attn, ms_deform_attn_backward, dynamic_mask_render)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = []
    for batch in batches[1:1 + n_steps]:
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = [fn.launches for fn in counters]
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{name}, {n_steps} steps of {TRAIN_BATCH}x{TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]}: launches K1 {launches[0]}, K2 {launches[1]}, "
          f"K3 {launches[2]}")
    if launches != [c.enc_layers * n_steps] * 2 + [0]:
        raise AssertionError("launch counts do not match the train steps run")
    losses = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    changed = sum(bool((p.detach() != before[n]).any())
                  for n, p in model.named_parameters())
    print(f"parameter tensors changed by the steps: {changed} of {len(before)}")
    if changed < 0.9 * len(before):
        raise AssertionError("the optimizer left the parameters unchanged")

    # the steps' device time, from a trace that kept K1's launches (all
    # but one at most)
    n_prof = 2
    profiled = itertools.cycle(batches[1 + n_steps:])

    def why_again(events):
        k1_events = sum(e.count for e in events if "msdeform_fwd_kernel" in e.key)
        if abs(k1_events - c.enc_layers * n_prof) <= 1:
            return None
        return f"it holds {k1_events} of K1's {c.enc_layers * n_prof} launches"

    events = sorted(trace_kernels(lambda: step(next(profiled)), n_prof, why_again),
                    key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in events) / n_prof / 1e3
    host_ms = statistics.median(step_ms)
    print(f"{name} step {host_ms:.3f} ms (host clock, median of "
          f"{n_steps}: " + " ".join(f"{t:.1f}" for t in step_ms)
          + f"), {dev_ms:.3f} ms of it device time ({1 - dev_ms / host_ms:.1%} "
          f"idle), peak {peak / 2**30:.3f} GiB allocated, on {card}")
    print(f"{name} step device time by kernel (top 20, ms per step, launches):")
    for e in events[:20]:
        print(f"  {e.self_device_time_total / n_prof / 1e3:8.3f} "
              f"{e.count // n_prof:5d}  {e.key[:110]}")
    print("losses of the last counted step: " + json.dumps(
        {k: round(v, 6) for k, v in losses.items()}))
    return launches, time_k2_on_model_inputs(k2_calls)


def entry_device_time(main_torch, cfg_args, opts, tmp, k1_launches, card) -> None:
    """The same ``main_torch.py`` run again, into a fresh output directory,
    under ``torch.profiler``: the device time of the whole run and K1's
    share of it (kernel events the trace kept; its wall time is the
    profiler's, not the run's)."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(tmp, "profiled")
    opts = [str(out) if o == tmp else f"{out}/test" if o == f"{tmp}/test" else o
            for o in opts]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        main_torch.main(cfg_args + ["--opts", *opts])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events) / 1e3
    k1 = [e for e in events if "msdeform_fwd_kernel" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1) / 1e3
    k1_n = sum(e.count for e in k1)
    print(f"main_torch.py, profiled run: {total:.3f} ms of device time, K1 {k1_ms:.3f} ms "
          f"of it in {k1_n} kernel events kept of {k1_launches} launches "
          f"({k1_ms / max(k1_n, 1):.4f} ms each), on {card}")


def cvppp_entry_args(tmp):
    """Phase 8's ``main_torch.py`` arguments (the CVPPP YAMLs on synthetic
    data, ENTRY_ITERS iterations, checkpoints at 2 and 4, a validation at
    the end), writing into ``tmp``: (config args, --opts list)."""
    cfg_args = ["--config-base", str(REPO / "configs/CVPPP/CVPPP-PCTrans-Base.yaml"),
                "--config-file", str(REPO / "configs/CVPPP/CVPPP-PCTrans.yaml")]
    opts = ["DATASET.DATA_TYPE", "synthetic",
            "SOLVER.ITERATION_TOTAL", str(ENTRY_ITERS), "SOLVER.ITERATION_SAVE", "2",
            "SOLVER.START_SAVE", "0", "SOLVER.ITERATION_VAL", str(ENTRY_ITERS),
            "DATASET.OUTPUT_PATH", tmp, "INFERENCE.OUTPUT_PATH", f"{tmp}/test",
            "MONITOR.TENSORBOARD", "False", "MONITOR.ITERATION_NUM", "[1, 200]"]
    return cfg_args, opts


def entry_points(card, keep: Path):
    """``scripts/main_torch.py`` as a user runs it (K1 forward, K2 backward,
    K5 never), then ``scripts/eval_torch.py`` over its checkpoints.  The
    last checkpoint is copied into ``keep`` (phase 14 scores it on the
    on-disk tree).  Returns the training run's K5 launches (asserted 0)
    and its per-iteration records."""
    import shutil

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
        cfg_args, opts = cvppp_entry_args(tmp)
        for fn in counters:
            fn.launches = 0
        trainer_module.make_train_step = timed_steps
        try:
            t0 = time.perf_counter()
            trainer = main_torch.main(cfg_args + ["--opts", *opts])
            train_wall = time.perf_counter() - t0
        finally:
            trainer_module.make_train_step = make_step
        k1, k5, k2, k3, k4 = [fn.launches for fn in counters]
        fwd = trainer.evaluator.forwards
        c = trainer.model_config
        print(f"main_torch.py, {ENTRY_ITERS} bf16 iterations "
              f"of {trainer.cfg.SOLVER.SAMPLES_PER_BATCH}x{trainer.cfg.MODEL.INPUT_SIZE} + "
              f"{fwd} validation forwards: launches K1 {k1}, K5 {k5}, K2 {k2}, K3 {k3}, K4 {k4}")
        if [k1, k5, k2, k3, k4] != [c.enc_layers * (ENTRY_ITERS + fwd), 0,
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
        k5_train, phase8_train = k5, train
        print(f"per-loss records of {len(train[0]) - 2} terms, finite; validation "
              f"{evals[0]}; checkpoints {saved}")
        print(f"host ms per train iteration (synchronised): "
              + " ".join(f"{t:.1f}" for t in step_ms)
              + f"; main_torch.py wall {train_wall:.3f} s, on {card}")
        entry_device_time(main_torch, cfg_args, opts, tmp, k1, card)

        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        records = eval_torch.main(cfg_args + ["--start", "0", "--out", f"{tmp}/sweep.json",
                                              "--opts", *opts])
        sweep_wall = time.perf_counter() - t0
        k1, k5, k2, k3, k4 = [fn.launches for fn in counters]
        print(f"eval_torch.py: {len(records)} records "
              f"{records}; launches K1 {k1}, K3 {k3}, K4 {k4} (one per forward), "
              f"K5 {k5}, K2 {k2}; sweep wall {sweep_wall:.3f} s, on {card}")
        if [r["iter"] for r in records] != [2, 4] or \
                json.loads(Path(tmp, "sweep.json").read_text()) != records:
            raise AssertionError("the sweep did not score the two checkpoints")
        if k4 < 4 or [k1, k3, k5, k2] != [c.enc_layers * k4, (c.dec_layers + 1) * k4, 0, 0]:
            raise AssertionError("sweep launch counts do not match its forwards")
        keep.mkdir(parents=True)
        shutil.copy(Path(tmp, f"checkpoint_{ENTRY_ITERS:06d}.pth.tar"), keep)
    return k5_train, phase8_train


def entry_points_bbbc(card, keep: Path):
    """``scripts/main_torch.py`` with the two BBBC YAMLs on ``synthetic_bbbc``
    (2 bf16 iterations at 512x512 batch 2, MAX_INSTANCES 128, a checkpoint
    and a validation at 2: ``test_bbbc``, AJI to ``logging.txt``,
    ``checkpoint_best``), then ``scripts/eval_torch.py --name bbbc`` over its
    checkpoint; the default dispatch (K1).  The checkpoint is copied into
    ``keep``.  Returns the run's launches (K1, K2, K3, K4)."""
    import shutil

    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    sys.path.insert(0, str(REPO / "scripts"))
    import eval_torch
    import main_torch

    counters = (ms_deform_attn, ms_deform_attn_backward, dynamic_mask_render,
                resize_bilinear_binarize)
    metrics = ["AJI", "F1", "detF1", "PQ"]
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        cfg_args = ["--config-base", str(REPO / "configs/BBBC/BBBC-PCTrans-Base.yaml"),
                    "--config-file", str(REPO / "configs/BBBC/BBBC-PCTrans.yaml")]
        it = BBBC_ENTRY_ITERS
        opts = ["DATASET.DATA_TYPE", "synthetic_bbbc",
                "SOLVER.ITERATION_TOTAL", str(it), "SOLVER.ITERATION_SAVE", str(it),
                "SOLVER.START_SAVE", "0", "SOLVER.ITERATION_VAL", str(it),
                "DATASET.OUTPUT_PATH", tmp, "INFERENCE.OUTPUT_PATH", f"{tmp}/test",
                "MONITOR.TENSORBOARD", "False", "MONITOR.ITERATION_NUM", "[1, 200]"]
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = main_torch.main(cfg_args + ["--opts", *opts])
        train_wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        fwd = trainer.evaluator.forwards
        c, cfg = trainer.model_config, trainer.cfg
        print(f"main_torch.py, BBBC YAMLs on synthetic_bbbc, {it} bf16 iterations of "
              f"{cfg.SOLVER.SAMPLES_PER_BATCH}x{cfg.MODEL.INPUT_SIZE}, MAX_INSTANCES "
              f"{cfg.MODEL.MAX_INSTANCES}, Q={c.num_queries}, + {fwd} validation forwards: "
              f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, K4 "
              f"{launches[3]}; wall {train_wall:.3f} s, on {card}")
        if (c.num_queries, cfg.MODEL.MAX_INSTANCES, list(cfg.MODEL.INPUT_SIZE),
                cfg.SOLVER.SAMPLES_PER_BATCH) != (300, 128, [512, 512], 2):
            raise AssertionError("the BBBC entry-point run is not the BBBC recipe")
        if fwd < 4 or launches != [c.enc_layers * (it + fwd), c.enc_layers * it,
                                   (c.dec_layers + 1) * fwd, fwd]:
            raise AssertionError("BBBC entry-point launch counts do not match the run")
        lines = [json.loads(l) for l in Path(tmp, "metrics.jsonl").read_text().splitlines()]
        train = [r for r in lines if "eval" not in r]
        evals = [r["eval"] for r in lines if "eval" in r]
        if ([r["iter"] for r in train] != list(range(it)) or len(evals) != 1
                or not set(metrics) <= set(evals[0])
                or not all(math.isfinite(v) for r in train + evals for v in r.values())):
            raise AssertionError(f"metrics.jsonl records {lines}")
        saved = sorted(f for f in os.listdir(tmp) if f.endswith(".pth.tar"))
        log = Path(tmp, "test", "logging.txt").read_text().splitlines()
        if saved != [f"checkpoint_{it:06d}.pth.tar", "checkpoint_best.pth.tar"] or \
                log[:2] != [f"val_{it:06d}", " ".join(str(evals[0][k]) for k in metrics)]:
            raise AssertionError(f"checkpoints {saved}, logging.txt {log}")
        print(f"validation {evals[0]}; checkpoints {saved}; logging.txt {log}")

        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        records = eval_torch.main(cfg_args + ["--name", "bbbc", "--start", "0",
                                              "--opts", *opts])
        sweep_wall = time.perf_counter() - t0
        k1, k2, k3, k4 = [fn.launches for fn in counters]
        print(f"eval_torch.py --name bbbc: {records}; launches K1 {k1}, K3 {k3}, K4 {k4} "
              f"(one per forward), K2 {k2}; sweep wall {sweep_wall:.3f} s, on {card}")
        if [r["iter"] for r in records] != [it] or \
                not all(math.isfinite(records[0][k]) for k in metrics):
            raise AssertionError("the BBBC sweep did not score the checkpoint")
        if k4 < 4 or [k1, k3, k2] != [c.enc_layers * k4, (c.dec_layers + 1) * k4, 0]:
            raise AssertionError("BBBC sweep launch counts do not match its forwards")
        keep.mkdir(parents=True)
        shutil.copy(Path(tmp, f"checkpoint_{it:06d}.pth.tar"), keep)
    return launches


def criterion_card_vs_cpu(crit, outputs, targets, reid, draws) -> float:
    """The criterion on the card and on a CPU copy of the same outputs,
    targets and draws: every loss (both at the card's assignment) and each
    lane's matched cost (each side at its own) within CRITERION_RTOL.  The
    re-id clusters are an argmax over the queries' cosine similarities, so
    where a near-tie falls the other way on the CPU, its re-id terms are
    taken again at the card's similarities, and the similarities are held
    within CRITERION_RTOL on their own.  Returns the largest relative
    difference."""
    from pctrans_torch.losses.contrast import (_clusters, cosine_similarity_matrix,
                                               pairwise_mask_dice, reid_losses)

    def cpu(t):
        return t.detach().cpu()

    def copy(tree):
        return {k: [cpu(a) for a in v] if isinstance(v, list) else cpu(v)
                for k, v in tree.items() if v is not None}

    def matched(stacked, tgt, d):
        idx, costs, _ = crit.match_with_costs(stacked, tgt, d)
        lane = torch.gather(costs, 2, idx[:, :, None, :]).squeeze(2)     # [L, B, G]
        return idx, (lane * tgt["valid"]).sum(-1).double()

    with torch.no_grad():
        stacked = torch.stack(outputs["aux_masks"] + [outputs["pred_masks"]])
        idx, cost = matched(stacked, targets, draws)
        _, losses, _ = crit(outputs, targets, reid, draws, indices=idx)
        c_out, c_tgt, c_draws = copy(outputs), copy(targets), copy(draws)
        c_idx, c_cost = matched(torch.stack(c_out["aux_masks"] + [c_out["pred_masks"]]),
                                c_tgt, c_draws)
        _, c_losses, _ = crit(c_out, c_tgt, cpu(reid), c_draws, indices=cpu(idx))
        sims = cpu(cosine_similarity_matrix(outputs["query_emb"]))
        c_sims = cosine_similarity_matrix(c_out["query_emb"])
        keys, valid = cpu(idx[-1]), c_tgt["valid"]
        moved = int((_clusters(sims, keys, valid)[0] != _clusters(c_sims, keys, valid)[0])
                    .any(-1).sum())
        if moved:
            cq, aq, cm, n = reid_losses(c_out["query_emb"], sims,
                                        pairwise_mask_dice(c_out["pred_masks"]), keys, valid,
                                        cpu(reid))
            n = n.sum().float().clamp(min=1.0)
            c_losses.update(loss_reid_query=cq.sum() / n, loss_reid_query_aux=aq.sum() / n,
                            loss_reid_mask=cm.sum() / n)
    worst = 0.0
    pairs = [(f"matched cost {l},{b}", float(cost[l, b]), float(c_cost[l, b]))
             for l in range(cost.shape[0]) for b in range(cost.shape[1])]
    pairs += [(k, float(v), float(c_losses[k])) for k, v in losses.items()]
    for name, a, b in pairs:
        rel = abs(a - b) / max(abs(b), 1e-6)
        worst = max(worst, rel)
        if not (math.isfinite(a) and rel <= CRITERION_RTOL):
            raise AssertionError(f"criterion card vs CPU, {name}: {a} against {b}")
    sims_rel = rel_fro(sims, c_sims)
    if not sims_rel <= CRITERION_RTOL:
        raise AssertionError(f"criterion card vs CPU, query cosine similarities: {sims_rel}")
    flips = int((idx.cpu() != c_idx)[:, targets["valid"].cpu()].sum())
    print(f"  criterion card vs CPU: {len(losses)} losses and {cost.numel()} matched costs "
          f"within rel {worst:.2e}; {flips} slots matched to another query at equal cost; "
          f"query similarities rel-Fro {sims_rel:.2e}, {moved} re-id cluster(s) of another "
          "membership at a near-tie (their terms taken at the card's similarities)")
    return max(worst, sims_rel)


def train_sampled_modes(dev, card) -> dict:
    """Phase 7b: the bf16 recipe's train step under the sampled point modes
    and under the published estimator (``REFERENCE_ESTIMATOR`` with
    UPSAMPLE2X).  Returns {mode: (K1, K2) launches over the counted steps}."""
    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.data.targets import targets_from_labels
    from pctrans_torch.engine.solver import (CVPPP_SOLVER, build_lr_scheduler,
                                             build_optimizer)
    from pctrans_torch.engine.train_step import make_train_step
    from pctrans_torch.losses.criterion import CVPPP_CRITERION, SetCriterion
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward
    from pctrans_torch.ops.render import dynamic_mask_render

    modes = [(m, {"point_select": m}, False) for m in ("shared", "weighted", "topk")]
    modes.append(("exact (the published estimator)", REFERENCE_ESTIMATOR, True))
    counters = (ms_deform_attn, ms_deform_attn_backward, dynamic_mask_render)
    c = CVPPP_RECIPE
    out = {}
    for name, over, upsample2x in modes:
        config = dataclasses.replace(CVPPP_RECIPE, upsample2x=upsample2x)
        model = build_model(config, dev)
        crit = SetCriterion(dataclasses.replace(CVPPP_CRITERION, **over))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        opt = build_optimizer(model, CVPPP_SOLVER)
        step = make_train_step(model, crit, opt, build_lr_scheduler(opt, CVPPP_SOLVER),
                               MAX_INSTANCES, gen, solver=CVPPP_SOLVER)
        batches = list(scene_batches(SAMPLED_STEPS + 3, SEED + 5, TRAIN_BATCH, TRAIN_HW))
        step(batches[0])
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = []
        for batch in batches[1:1 + SAMPLED_STEPS]:
            t0 = time.perf_counter()
            metrics = step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = [fn.launches for fn in counters]
        peak = torch.cuda.max_memory_allocated(dev)
        if launches != [c.enc_layers * SAMPLED_STEPS] * 2 + [0]:
            raise AssertionError(f"{name}: launches K1, K2, K3 {launches} in "
                                 f"{SAMPLED_STEPS} steps")
        losses = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{name}: non-finite losses {losses}")

        profiled = itertools.cycle(batches[1 + SAMPLED_STEPS:])

        def why_again(events):
            k1 = sum(e.count for e in events if "msdeform_fwd_kernel" in e.key)
            return None if abs(k1 - c.enc_layers) <= 1 else \
                f"it holds {k1} of K1's {c.enc_layers} launches"

        events = sorted(trace_kernels(lambda: step(next(profiled)), 1, why_again),
                        key=lambda e: -e.self_device_time_total)
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        host_ms = statistics.median(step_ms)
        print(f"{name}: train step {host_ms:.3f} ms (host clock, median of {SAMPLED_STEPS}: "
              + " ".join(f"{t:.1f}" for t in step_ms) + f"), {dev_ms:.3f} ms device "
              f"({1 - dev_ms / host_ms:.1%} idle), peak {peak / 2**30:.3f} GiB, launches "
              f"per step K1 {launches[0] // SAMPLED_STEPS}, K2 {launches[1] // SAMPLED_STEPS}, "
              f"loss {losses['loss']:.4f}, on {card}")
        print("  largest device kernels (ms per step, launches): " + "; ".join(
            f"{e.self_device_time_total / 1e3:.3f} x{e.count} {e.key[:60]}"
            for e in events[:6]))

        batch = batches[-1]
        labels = torch.as_tensor(batch["label"]).to(dev).int()
        targets = targets_from_labels(labels, MAX_INSTANCES)
        reid, draws = crit.draws(TRAIN_BATCH, MAX_INSTANCES, c.num_queries, gen, dev)
        model.train()
        with torch.no_grad():
            outputs = model(torch.as_tensor(batch["image"]).to(dev).float())
        criterion_card_vs_cpu(crit, outputs, targets, reid, draws)
        out[name] = tuple(launches[:2])
        del model, opt, step, outputs
        torch.cuda.empty_cache()
    return out


def entry_points_settings(card):
    """Phase 8c: ``scripts/main_torch.py`` with the CVPPP YAMLs under
    ``SETTINGS_OPTS`` (4 iterations, checkpoints at 2 and 4), then
    ``scripts/eval_torch.py --checkpoint`` over ``checkpoint_swa.pth.tar``.
    Returns the run's and the evaluation's launches."""
    import pctrans_torch.engine.trainer as trainer_module
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    sys.path.insert(0, str(REPO / "scripts"))
    import eval_torch
    import main_torch

    counters = (ms_deform_attn, ms_deform_attn_backward, dynamic_mask_render,
                resize_bilinear_binarize)
    applied = []                      # the rate each update ran at
    make_step = trainer_module.make_train_step

    def recording_steps(*args, **kwargs):
        step, optimizer = make_step(*args, **kwargs), args[2]

        def run(batch, **kw):
            if batch["image"].dtype != np.uint8 or batch["label"].dtype != np.uint8:
                raise AssertionError("TRANSFER_UINT8: the step got "
                                     f"{batch['image'].dtype} / {batch['label'].dtype}")
            applied.append(optimizer.param_groups[0]["lr"])
            return step(batch, **kw)
        return run

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        cfg_args = ["--config-base", str(REPO / "configs/CVPPP/CVPPP-PCTrans-Base.yaml"),
                    "--config-file", str(REPO / "configs/CVPPP/CVPPP-PCTrans.yaml")]
        opts = ["DATASET.DATA_TYPE", "synthetic",
                "SOLVER.ITERATION_TOTAL", str(ENTRY_ITERS), "SOLVER.ITERATION_SAVE", "2",
                "SOLVER.START_SAVE", "0", "SOLVER.ITERATION_VAL", "0",
                "DATASET.OUTPUT_PATH", tmp, "INFERENCE.OUTPUT_PATH", f"{tmp}/test",
                "MONITOR.TENSORBOARD", "False", "MONITOR.ITERATION_NUM", "[1, 200]",
                *SETTINGS_OPTS]
        for fn in counters:
            fn.launches = 0
        trainer_module.make_train_step = recording_steps
        try:
            t0 = time.perf_counter()
            trainer = main_torch.main(cfg_args + ["--opts", *opts])
            train_wall = time.perf_counter() - t0
        finally:
            trainer_module.make_train_step = make_step
        launches = [fn.launches for fn in counters]
        c, cfg = trainer.model_config, trainer.cfg
        # 2 BatchNorm-refresh forwards at each SWA save: after 2 and 4, and at the end
        refresh = 3 * cfg.SOLVER.SWA.BN_UPDATE_ITER
        print(f"main_torch.py under {' '.join(SETTINGS_OPTS)}: {ENTRY_ITERS} iterations, "
              f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, K4 "
              f"{launches[3]}; wall {train_wall:.3f} s, on {card}")
        if (not c.upsample2x or trainer.solver.clip_type != "full_model"
                or launches != [c.enc_layers * (ENTRY_ITERS + refresh),
                                c.enc_layers * ENTRY_ITERS, 0, 0]):
            raise AssertionError("phase 8c's run is not the configured one")
        lines = [json.loads(l) for l in Path(tmp, "metrics.jsonl").read_text().splitlines()]
        logged = [r["lr"] for r in lines]
        if [r["iter"] for r in lines] != list(range(ENTRY_ITERS)) or len(applied) != \
                ENTRY_ITERS or any(abs(a - b) > 1e-9 * b for a, b in zip(logged, applied)) \
                or not all(math.isfinite(v) for r in lines for v in r.values()):
            raise AssertionError(f"metrics.jsonl {lines}, rates applied {applied}")
        saved = sorted(f for f in os.listdir(tmp) if f.endswith(".pth.tar"))
        if saved != ["checkpoint_000002.pth.tar", "checkpoint_000004.pth.tar",
                     "checkpoint_swa.pth.tar"]:
            raise AssertionError(f"checkpoints {saved}")
        print(f"rates logged {logged}, each the one the optimizer applied; "
              f"checkpoints {saved}")

        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        records = eval_torch.main(cfg_args + ["--checkpoint", f"{tmp}/checkpoint_swa.pth.tar",
                                              "--opts", *opts])
        sweep_wall = time.perf_counter() - t0
        k1, k2, k3, k4 = [fn.launches for fn in counters]
        print(f"eval_torch.py --checkpoint checkpoint_swa.pth.tar: {records}; launches K1 "
              f"{k1}, K3 {k3}, K4 {k4} (one per forward), K2 {k2}; wall {sweep_wall:.3f} s")
        if [r["iter"] for r in records] != [ENTRY_ITERS] or \
                not all(math.isfinite(v) for v in records[0].values()):
            raise AssertionError("eval_torch.py did not score the SWA checkpoint")
        if k4 < 1 or [k1, k3, k2] != [c.enc_layers * k4, (c.dec_layers + 1) * k4, 0]:
            raise AssertionError("phase 8c's evaluation launch counts do not match")
    return launches, (k1, k3, k4)


# ------------------------------------------------------------ phases 9, 9b
SWIN_TRAIN_STEPS = 3           # counted Swin-T train steps (phase 9), after one warm-up
SWIN_ENTRY_ITERS = 2           # iterations of the Swin-T entry-point run
# phase 9b: the other components over the R-50 recipe
ALT_COMBINATIONS = [
    ("R-50 + fpn_legacy_swap", dict(fpn_legacy_swap=True)),
    ("R-50 + BasePixelDecoder", dict(pixel_decoder_name="BasePixelDecoder")),
    ("R-50 + TransformerEncoderPixelDecoder + StandardTransformerDecoder",
     dict(pixel_decoder_name="TransformerEncoderPixelDecoder",
          transformer_decoder_name="StandardTransformerDecoder")),
]


def swin_recipe():
    """The CVPPP recipe with ``MODEL.BACKBONE.NAME D2SwinTransformer`` at the
    Swin-T defaults (embed 96, depths 2/2/6/2, heads 3/6/12/24, window 7,
    drop path 0.3)."""
    from pctrans_torch.config import CVPPP_RECIPE

    return dataclasses.replace(CVPPP_RECIPE, backbone_name="D2SwinTransformer")


def swin_phase(dev, card):
    """Phase 9: the Swin-T PCTrans at the CVPPP recipe's full width: the f32
    forward kernels vs twins (its backbone builds the attention's twin: K6
    is bf16 only), the bf16 evaluator (K1 and K6 gated and timed on their
    own inputs; K6 = 12 per forward), 1 + 3 bf16 train steps with drop path
    on (K2 gated on one step's own inputs; K6 = 0: training runs the twin).
    Returns (eval launches, K1 record, train launches, K2 record, K6
    record)."""
    from pctrans_torch.ops.window_attn import window_attention

    config = swin_recipe()
    slice_f32(dev, config, "Swin-T f32 slice")
    eval_launches, k1_model, _, k6_model = slice_bf16(dev, card, config,
                                                      "bf16 Swin-T CVPPP", with_k5=False)
    window_attention.launches = 0
    train_launches, k2_model = train_bf16(dev, card, config, SWIN_TRAIN_STEPS,
                                          "bf16 Swin-T train (drop path 0.3)")
    if window_attention.launches:
        raise AssertionError(f"K6 ran {window_attention.launches} times in Swin-T training")
    torch.cuda.empty_cache()
    return eval_launches, k1_model, train_launches, k2_model, k6_model


def swap_kernels_on_model_inputs(model, x, name) -> dict:
    """K3 on the ten renders and K4 on the upsample-binarize that one bf16
    eval step of the legacy-swap model gives them (stride-8 masks, 67x63
    at 530x500): each against its twin, then ms per launch beside the
    twin's."""
    import pctrans_torch.engine.eval_step as eval_step_module
    import pctrans_torch.models.transformer_decoder as decoder_module
    from pctrans_torch.engine.eval_step import make_eval_step
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize import resize_bilinear
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    k3_calls, k4_calls = [], []

    def keep_k3(*a):
        k3_calls.append(a)
        return dynamic_mask_render(*a)

    def keep_k4(*a):
        k4_calls.append(a)
        return resize_bilinear_binarize(*a)

    decoder_module.dynamic_mask_render = keep_k3
    eval_step_module.resize_bilinear_binarize = keep_k4
    try:
        make_eval_step(model, 50, 0.69)(x)
    finally:
        decoder_module.dynamic_mask_render = dynamic_mask_render
        eval_step_module.resize_bilinear_binarize = resize_bilinear_binarize
    grid = tuple(k3_calls[0][8])
    with torch.inference_mode():
        k3_errs = [rel_fro(dynamic_mask_render(*c), dynamic_mask_render(*c, impl="twin"))
                   for c in k3_calls]
        masks, hw, logit_t = k4_calls[0]
        out = resize_bilinear_binarize(masks, hw, logit_t)
        flips = out != resize_bilinear_binarize(masks, hw, logit_t, impl="twin")
        n_flips = int(flips.sum())
        worst = (float((resize_bilinear(masks, hw)[flips] - logit_t).abs().max())
                 if n_flips else 0.0)
        print(f"{name}: K3 on the eval step's {len(k3_calls)} renders at {grid}, rel-Fro to "
              "the twin " + " ".join(f"{e:.2e}" for e in k3_errs) + " (<= 1e-5); K4 "
              f"{tuple(masks.shape)} -> {hw}: {n_flips} of {out.numel()} bits flipped "
              f"(<= 1e-4 of them), largest |logit - t| at a flip {worst:.3e} (<= 1e-4)")
        if len(k3_calls) != model.config.dec_layers + 1 or grid != stage_sizes(IMAGE_HW)[1] or \
                not max(k3_errs) <= 1e-5 or n_flips > 1e-4 * out.numel() or worst > 1e-4:
            raise AssertionError(f"{name}: K3 or K4 disagrees with its twin at {grid}")
        n = len(k3_calls)
        run_k3 = lambda: [dynamic_mask_render(*c) for c in k3_calls]
        run_k4 = lambda: resize_bilinear_binarize(masks, hw, logit_t)
        rec = {"k3_ms": time_ms(run_k3) / n,
               "k3_plain_ms": time_ms(
                   lambda: [dynamic_mask_render(*c, impl="twin") for c in k3_calls]) / n,
               "k4_ms": time_ms(run_k4),
               "k4_plain_ms": time_ms(
                   lambda: resize_bilinear_binarize(masks, hw, logit_t, impl="twin"))}
        # both kernels' device time from one trace of both calls
        reps = 10

        def why_again(events):
            kept = [sum(e.count for e in events if k in e.key)
                    for k in ("render_kernel", "resize_binarize_kernel")]
            if kept[0] >= 0.75 * n * reps and kept[1] >= 0.75 * reps:
                return None
            return f"it holds {kept} of K3's and K4's {[n * reps, reps]} kernel events"

        events = trace_kernels(lambda: (run_k3(), run_k4()), reps, why_again)
        for key, kernel in (("k3", "render"), ("k4", "resize_binarize")):
            # each of the wrapper's kernels runs once per call: its mean
            # over the events kept, summed over the wrapper's kernels
            rec[f"{key}_device_ms"] = sum(e.self_device_time_total / e.count
                                          for e in events if kernel in e.key) / 1e3
    print(f"{name}, per launch on the model's inputs: K3 {rec['k3_ms']:.4f} ms/call "
          f"({rec['k3_device_ms']:.4f} ms device), twin {rec['k3_plain_ms']:.4f}; K4 "
          f"{rec['k4_ms']:.4f} ms/call ({rec['k4_device_ms']:.4f} ms device), twin "
          f"{rec['k4_plain_ms']:.4f}")
    return rec


def alt_combinations(dev, card):
    """Phase 9b: each of ``ALT_COMBINATIONS`` at the CVPPP recipe's width:
    its f32 forward kernels vs twins, then one bf16 eval batch of four
    530x500 scenes through the evaluator (launch counts per forward, labels
    against the numpy oracle, the forward's times); under the legacy swap
    K3 and K4 gated and timed on the stride-8 grid's own inputs.  Returns
    ({name: eval launches}, the legacy swap's K3/K4 record)."""
    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.engine.evaluator import Evaluator
    from pctrans_torch.inference.postprocess import instance_inference_cvppp

    launches, swap = {}, None
    for name, over in ALT_COMBINATIONS:
        config = dataclasses.replace(CVPPP_RECIPE, **over)
        # K1 per forward with the MSDeformAttn pixel decoder, K3 with the
        # PCTrans predictor, K4 once per eval step
        layers = (config.enc_layers
                  if config.pixel_decoder_name == "MSDeformAttnPixelDecoder" else 0,
                  config.dec_layers + 1
                  if config.transformer_decoder_name != "StandardTransformerDecoder" else 0, 1)
        slice_f32(dev, config, f"{name}, f32 slice")
        model = build_model(config, dev)
        ev = Evaluator(model, top_k=50)
        batches = list(scene_batches(1, SEED + 1))
        launches[name], fwd, wall, _ = eval_run(
            f"{name}, bf16 eval, batch {BATCH}, {IMAGE_HW}", ev, batches, ev.eval_cvppp,
            layers)
        check_labels(name, ev, batches, instance_inference_cvppp)
        x = torch.from_numpy(batches[0]["image"]).to(dev)
        with torch.inference_mode():
            out = model(x)
        grid = stage_sizes(IMAGE_HW)[1 if config.fpn_legacy_swap else 0]
        if tuple(out["pred_masks"].shape) != (BATCH, config.num_queries, *grid) or \
                not torch.isfinite(out["pred_masks"].float()).all():
            raise AssertionError(f"{name}: pred_masks {tuple(out['pred_masks'].shape)}")
        fwd_ms, fwd_dev = forward_times(model, x)
        print(f"{name}: bf16 forward {fwd_ms:.3f} ms/batch of {BATCH} (CUDA events), "
              f"{fwd_dev:.3f} ms of it device time ({1 - fwd_dev / fwd_ms:.1%} idle), "
              f"masks {tuple(out['pred_masks'].shape)}; {fwd} forwards in {wall:.3f} s "
              f"wall, on {card}")
        if config.fpn_legacy_swap:
            swap = swap_kernels_on_model_inputs(model, x, name)
        del model, ev, out
        torch.cuda.empty_cache()
    return launches, swap


def entry_points_swin(card):
    """``scripts/main_torch.py --opts MODEL.BACKBONE.NAME D2SwinTransformer
    DATASET.DATA_TYPE synthetic ...`` with the CVPPP YAMLs: 2 bf16
    iterations at 448x448 batch 2 and a checkpoint at 2, then
    ``scripts/eval_torch.py`` over it.  Returns the run's launches (K1, K2,
    K3, K4, K6) and the sweep's (K1, K3, K4, K6): K6 serves every block of
    the sweep's forwards and none of the training."""
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize
    from pctrans_torch.ops.window_attn import window_attention

    sys.path.insert(0, str(REPO / "scripts"))
    import eval_torch
    import main_torch

    counters = (ms_deform_attn, ms_deform_attn_backward, dynamic_mask_render,
                resize_bilinear_binarize, window_attention)
    it = SWIN_ENTRY_ITERS
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        cfg_args = ["--config-base", str(REPO / "configs/CVPPP/CVPPP-PCTrans-Base.yaml"),
                    "--config-file", str(REPO / "configs/CVPPP/CVPPP-PCTrans.yaml")]
        opts = ["MODEL.BACKBONE.NAME", "D2SwinTransformer", "DATASET.DATA_TYPE", "synthetic",
                "SOLVER.ITERATION_TOTAL", str(it), "SOLVER.ITERATION_SAVE", str(it),
                "SOLVER.START_SAVE", "0", "SOLVER.ITERATION_VAL", "0",
                "DATASET.OUTPUT_PATH", tmp, "INFERENCE.OUTPUT_PATH", f"{tmp}/test",
                "MONITOR.TENSORBOARD", "False", "MONITOR.ITERATION_NUM", "[1, 200]"]
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = main_torch.main(cfg_args + ["--opts", *opts])
        train_wall = time.perf_counter() - t0
        run = [fn.launches for fn in counters]
        c = trainer.model_config
        print(f"main_torch.py --opts MODEL.BACKBONE.NAME D2SwinTransformer, {it} bf16 "
              f"iterations of {trainer.cfg.SOLVER.SAMPLES_PER_BATCH}x"
              f"{trainer.cfg.MODEL.INPUT_SIZE}: launches K1 {run[0]}, K2 {run[1]}, K3 "
              f"{run[2]}, K4 {run[3]}, K6 {run[4]}; wall {train_wall:.3f} s, on {card}")
        if type(trainer.model.backbone).__name__ != "SwinTransformer" or \
                run != [c.enc_layers * it, c.enc_layers * it, 0, 0, 0]:
            raise AssertionError("the Swin-T entry-point run is not the configured one")
        lines = [json.loads(l) for l in Path(tmp, "metrics.jsonl").read_text().splitlines()]
        saved = sorted(f for f in os.listdir(tmp) if f.endswith(".pth.tar"))
        if [r["iter"] for r in lines] != list(range(it)) or \
                saved != [f"checkpoint_{it:06d}.pth.tar"] or \
                not all(math.isfinite(v) for r in lines for v in r.values()):
            raise AssertionError(f"metrics.jsonl {lines}, checkpoints {saved}")

        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        records = eval_torch.main(cfg_args + ["--start", "0", "--opts", *opts])
        sweep_wall = time.perf_counter() - t0
        k1, k2, k3, k4, k6 = [fn.launches for fn in counters]
        print(f"eval_torch.py over the Swin-T checkpoint: {records}; launches K1 {k1}, K3 "
              f"{k3}, K4 {k4} (one per forward), K6 {k6}, K2 {k2}; wall {sweep_wall:.3f} s, "
              f"on {card}")
        if [r["iter"] for r in records] != [it] or \
                not all(math.isfinite(v) for v in records[0].values()):
            raise AssertionError("eval_torch.py did not score the Swin-T checkpoint")
        if k4 < 4 or [k1, k3, k6, k2] != [c.enc_layers * k4, (c.dec_layers + 1) * k4,
                                          sum(c.swin_depths) * k4, 0]:
            raise AssertionError("the Swin-T sweep's launch counts do not match its forwards")
    return run, (k1, k3, k4, k6)


# ------------------------------------------------------- phases 10 to 13
DIST_STEPS = 2                 # counted train steps per rank in phase 10b/c, after one warm-up
DIST_TIMEOUT = 420             # seconds for each rank's process; a hung rank fails the phase
# world 1 against phase 8's losses: iteration 0 term by term (no update has
# run yet, and its forward has no atomics); later iterations by the total,
# since K2's float atomics round the gradients apart and, with random
# weights, an update of 1e-7 then flips attention-mask bits: phase 8's own
# profiled rerun of the same command parts from it by 1-2%, the world-1 run
# by up to 3% on the H100
DIST_LOSS_RTOL = (1e-4, 1e-1)
# world 2 at per-rank batch 1 against one process at batch 2, bf16, on the
# first step: the per-image convolutions and SyncBN's collective sums round
# otherwise, and a rounding that flips an attention-mask bit (sigmoid < 0.5)
# parts the decoder's later layers (the gradient norm 2.6% on the H100).
# Later steps are printed, not gated: with random weights an update of 1e-7
# flips such bits wherever the two runs' gradients round apart.  The ranks
# must agree with each other exactly: they share the all-reduced values
DIST_RANK_RTOL = 1e-1
MONITOR_ITERS = 4              # phase 13's iterations (profiled: [2, 3))
MONITOR_TRIES = 3              # runs before phase 13 gives up on a trace without K1/K2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(spec: dict, world: int, local_ranks, extra_env=None):
    """``world`` processes of ``chip_smoke.py --dist-worker`` rendezvousing
    through env:// on a free port; each prints one JSON line last.  A rank
    that fails or outlasts DIST_TIMEOUT fails the phase (the others are
    killed).  Returns the ranks' JSON records."""
    port = free_port()
    (REPO / "build").mkdir(exist_ok=True)
    spec_path = Path(tempfile.mkstemp(suffix=".json", dir=REPO / "build")[1])
    spec_path.write_text(json.dumps(spec))
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(local_ranks[r]),
                       **(extra_env or {}))
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--dist-worker",
                 str(spec_path), str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        deadline = time.monotonic() + DIST_TIMEOUT
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        spec_path.unlink()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-6000:])
            raise AssertionError(f"rank {r} of {world} exited {p.returncode}")
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


def dist_steps_record(dev, n_steps, world_rows):
    """1 + ``n_steps`` bf16 train steps of the seeded recipe on this
    process's rows of the global batches (two 448x448 scenes): the loss, the
    gradient global norm and the SyncBN running statistics after each step,
    and K1/K2 launches over the counted steps."""
    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.engine.solver import (CVPPP_SOLVER, build_lr_scheduler,
                                             build_optimizer)
    from pctrans_torch.engine.train_step import make_train_step
    from pctrans_torch.losses.criterion import SetCriterion, CVPPP_CRITERION
    from pctrans_torch.models.layers import BatchNorm
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward
    from pctrans_torch.parallel import mesh

    model = build_model(CVPPP_RECIPE, dev)
    opt = build_optimizer(model, CVPPP_SOLVER)
    step = make_train_step(model, SetCriterion(CVPPP_CRITERION), opt,
                           build_lr_scheduler(opt, CVPPP_SOLVER), MAX_INSTANCES,
                           torch.Generator(device=dev).manual_seed(SEED))
    syncbn = [m for m in model.modules() if isinstance(m, BatchNorm) and m.sync]
    rows = slice(world_rows[0], world_rows[1])
    rec = {"loss": [], "grad_norm": [], "stats": [], "step_ms": []}
    counters = (ms_deform_attn, ms_deform_attn_backward)
    batches = [{k: v[rows] for k, v in b.items()}
               for b in scene_batches(2 + n_steps, SEED + 2, TRAIN_BATCH, TRAIN_HW)]
    for i, mine in enumerate(batches[:-1]):
        if i == 1:
            for fn in counters:
                fn.launches = 0
        t0 = time.perf_counter()
        metrics = step(mine)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["loss"].append(float(metrics["loss"]))
        rec["grad_norm"].append(float(torch.sqrt(sum(
            (p.grad.float() ** 2).sum() for p in model.parameters() if p.grad is not None))))
        rec["stats"].append(torch.cat([torch.cat([m.running_mean, m.running_var])
                                       for m in syncbn]).tolist())
    rec["launches"] = [fn.launches for fn in counters]
    rec["rank"], rec["world"] = mesh.rank(), mesh.world_size()
    if dev.type == "cuda":
        # one more step's device time, in one trace taken on every rank (a
        # retrace on one rank alone would leave the others' collectives
        # waiting); a trace that kept no K1 event counts as not measured
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(batches[-1])
            torch.cuda.synchronize(dev)
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if any("msdeform_fwd_kernel" in e.key for e in events):
            rec["device_ms"] = sum(e.self_device_time_total for e in events) / 1e3
    return rec


def dist_worker(spec_path: str, rank: int) -> int:
    """One rank of phase 10 (``chip_smoke.py --dist-worker SPEC RANK``, with
    the env:// variables set by ``launch_ranks``); prints its JSON record
    last."""
    import datetime

    from pctrans_torch.ops import _build
    from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_backward,
                                            ms_deform_attn_separable)
    from pctrans_torch.parallel import mesh

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_kernels()
    if spec["kind"] == "main":
        sys.path.insert(0, str(REPO / "scripts"))
        import main_torch

        counters = (ms_deform_attn_separable, ms_deform_attn, ms_deform_attn_backward)
        for fn in counters:
            fn.launches = 0
        trainer = main_torch.main(spec["argv"])
        rec = {"launches": [fn.launches for fn in counters],
               "forwards": trainer.evaluator.forwards, "rank": mesh.rank(),
               "world": mesh.world_size(), "device": str(trainer.device),
               "backend": torch.distributed.get_backend()}
    else:
        dev = mesh.initialize_distributed(spec["backend"], spec["device"],
                                          timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
        per_rank = TRAIN_BATCH // mesh.world_size()
        rec = dist_steps_record(dev, DIST_STEPS, (rank * per_rank, (rank + 1) * per_rank))
        rec["device"] = str(dev)
        rec["backend"] = torch.distributed.get_backend()
    mesh.destroy()
    print(json.dumps(rec))
    return 0


def rel_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def step_device(rec) -> str:
    """The device ms of one step and its idle share against the median host
    ms of the counted steps."""
    if "device_ms" not in rec:
        return "; device ms not measured (the trace kept no K1 event)"
    host = statistics.median(rec["step_ms"][1:])
    return (f"; one more step {rec['device_ms']:.3f} ms device, "
            f"{1 - rec['device_ms'] / host:.1%} idle against the counted steps' median")


def compare_ranks(name, ranks, ref, card):
    """Phase 10b/c: each rank's losses, gradient global norms and SyncBN
    running statistics after every step against one process at the global
    batch, and K1/K2 launches per rank (6 each per counted step)."""
    from pctrans_torch.config import CVPPP_RECIPE

    enc = CVPPP_RECIPE.enc_layers
    for r in ranks:
        diffs = {k: [rel_diff(a, b) for a, b in zip(r[k], ref[k])]
                 for k in ("loss", "grad_norm", "stats")}
        print(f"{name} rank {r['rank']} of {r['world']} ({r['backend']}, {r['device']}): "
              f"loss {r['loss']} vs {ref['loss']}; rel-diff per step (the first gated at "
              f"{DIST_RANK_RTOL}): loss " + " ".join(f"{v:.3e}" for v in diffs["loss"])
              + ", gradient global norm " + " ".join(f"{v:.3e}" for v in diffs["grad_norm"])
              + ", SyncBN running statistics " + " ".join(f"{v:.3e}" for v in diffs["stats"])
              + f"; launches K1 {r['launches'][0]}, K2 {r['launches'][1]} "
              f"in {DIST_STEPS} steps; host ms per step "
              + " ".join(f"{t:.1f}" for t in r["step_ms"]) + step_device(r) + f", on {card}")
        if r["launches"] != [enc * DIST_STEPS] * 2:
            raise AssertionError(f"{name}: rank {r['rank']} did not launch K1/K2 per step")
        if not all(v[0] <= DIST_RANK_RTOL for v in diffs.values()):
            raise AssertionError(f"{name}: rank {r['rank']} is not the global batch's step")
    if any(ranks[0][k] != ranks[1][k] for k in ("loss", "grad_norm", "stats")):
        raise AssertionError(f"{name}: the ranks report different global losses, "
                             "gradients or statistics")


def distributed_phase(dev, card, phase8_train):
    """Phase 10.  (a) ``scripts/main_torch.py --distributed`` as world 1
    through env:// on NCCL with phase 8's arguments: its per-iteration
    losses against phase 8's, its files those of one run.  (b) Two gloo ranks on the one card at
    per-rank batch 1 against one process at batch 2 (NCCL refuses two ranks
    on one device).  (c) The same on NCCL, one card per rank, where a second
    card exists.  Returns the launches of (a) and of (b)'s ranks."""
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        cfg_args, opts = cvppp_entry_args(tmp)
        t0 = time.perf_counter()
        (rec,) = launch_ranks({"kind": "main", "argv": ["--distributed", *cfg_args,
                                                          "--opts", *opts]},
                              1, [0])
        wall = time.perf_counter() - t0
        lines = [json.loads(l) for l in Path(tmp, "metrics.jsonl").read_text().splitlines()]
        train = [r for r in lines if "eval" not in r]
        files = sorted(os.listdir(tmp))
        first = max(rel_diff(train[0][k], phase8_train[0][k]) for k in phase8_train[0]
                    if k != "iter")
        totals = [rel_diff(a["loss"], b["loss"]) for a, b in zip(train, phase8_train)]
        k5, k1, k2 = rec["launches"]
        print(f"10a main_torch.py --distributed, world {rec['world']} on {rec['backend']} "
              f"({rec['device']}): {len(train)} iterations, "
              f"launches K5 {k5}, K1 {k1}, K2 {k2}; losses against phase 8's: iteration 0 "
              f"largest rel-diff of a term {first:.3e} (<= {DIST_LOSS_RTOL[0]}), the total "
              "per iteration " + " ".join(f"{v:.3e}" for v in totals)
              + f" (<= {DIST_LOSS_RTOL[1]}); files {files}; process wall {wall:.3f} s, on "
              f"{card}")
        if (rec["world"], rec["backend"]) != (1, "nccl" if dev.type == "cuda" else "gloo") or \
                [r["iter"] for r in train] != [r["iter"] for r in phase8_train] or \
                first > DIST_LOSS_RTOL[0] or max(totals) > DIST_LOSS_RTOL[1]:
            raise AssertionError("10a: the world-1 run is not phase 8's")
        if files != ["checkpoint_000002.pth.tar", "checkpoint_000004.pth.tar",
                     "checkpoint_best.pth.tar", "config.yaml", "metrics.jsonl", "test", "vis"] \
                or len(lines) != len(train) + 1 or [k5, k1, k2] != \
                [0, 6 * (ENTRY_ITERS + rec["forwards"]), 6 * ENTRY_ITERS]:
            raise AssertionError(f"10a: the run wrote {files} and {len(lines)} records")

    ref = dist_steps_record(dev, DIST_STEPS, (0, TRAIN_BATCH))
    print(f"10 one process at batch {TRAIN_BATCH}: losses {ref['loss']}, gradient global "
          f"norms {ref['grad_norm']}, host ms per step "
          + " ".join(f"{t:.1f}" for t in ref["step_ms"]) + step_device(ref))
    spec = {"kind": "steps", "backend": "gloo", "device": dev.type}
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, 2, [0, 0])
    print(f"10b two gloo ranks on one card: {time.perf_counter() - t0:.3f} s for both "
          "processes")
    compare_ranks("10b", ranks, ref, card)
    if torch.cuda.device_count() >= 2:
        nccl = launch_ranks(dict(spec, backend="nccl"), 2, [0, 1])
        compare_ranks("10c", nccl, ref, card)
    else:
        print(f"10c two NCCL ranks, one card each: not run, {torch.cuda.device_count()} "
              "card in this machine")
    return rec["launches"], [r["launches"] for r in ranks]


def pipelined_vs_serial(name, ev, batches, card):
    """Phase 11 for one recipe: the serial ``predict_labels`` and the
    ``_label_pipeline`` over the same batches with the same model, labels
    bit-equal; img/s of each, timed in turns (serial, pipelined, pipelined,
    serial) after a warm-up of each, and each one's device idle share (the
    kernels' time in a profiled run of the same work over the median wall
    time).  Launches are counted in the first timed run of each.  Returns
    the pipeline's (K1, K3, K4) launches."""
    from torch.profiler import ProfilerActivity, profile

    from pctrans_torch.ops.msdeform import ms_deform_attn
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    runs = {"serial": lambda: [ev.predict_labels(b["image"]) for b in batches],
            "pipelined": lambda: [lab for _, lab in ev._label_pipeline(batches)]}
    counters = (ms_deform_attn, dynamic_mask_render, resize_bilinear_binarize)
    for fn in runs.values():
        fn()              # warm-up: the pipeline holds more batches' buffers at once
    out, walls, counts = {}, {k: [] for k in runs}, {}
    for key in ("serial", "pipelined", "pipelined", "serial"):
        for c in counters:
            c.launches = 0
        ev.forwards = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = runs[key]()
        torch.cuda.synchronize()
        walls[key].append(time.perf_counter() - t0)
        out.setdefault(key, labels)
        counts.setdefault(key, ([c.launches for c in counters], ev.forwards))
    n_img = sum(len(b["image"]) for b in batches)
    rates = {}
    for key, fn in runs.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        wall = statistics.median(walls[key])
        rates[key] = n_img / wall
        launches, fwd = counts[key]
        print(f"11 {name} {key}: " + " ".join(f"{n_img / w:.3f}" for w in walls[key])
              + f" img/s in turns ({n_img} images, {fwd} forwards each), {dev_ms:.3f} ms "
              f"device in a profiled run, idle {1 - dev_ms / (wall * 1e3):.1%} against the "
              f"median wall; launches K1 {launches[0]}, K3 {launches[1]}, K4 {launches[2]}, "
              f"on {card}")
        if launches != [6 * fwd, 10 * fwd, fwd] or dev_ms <= 0:
            raise AssertionError(f"11 {name} {key}: launches do not match the forwards, or "
                                 "the trace held no device time")
    differ = [int((a != b).sum()) for a, b in zip(out["serial"], out["pipelined"])]
    print(f"11 {name}: pixels that differ between the pipelined and serial labels, per "
          f"batch: {differ}; pipelined / serial img/s (medians) "
          f"{rates['pipelined'] / rates['serial']:.3f}")
    if any(differ) or any(a.dtype != b.dtype for a, b in zip(out["serial"], out["pipelined"])):
        raise AssertionError(f"11 {name}: the pipelined labels are not the serial ones")
    return counts["pipelined"][0]


def pipeline_phase(dev, card):
    """Phase 11: the label pipeline against the serial path, CVPPP (530x500,
    batch 4, TOP_K 50) and BBBC (520x696, batch 2, Q=300, TOP_K 160), three
    batches each, seeded random weights."""
    from pctrans_torch.config import BBBC_RECIPE, CVPPP_RECIPE
    from pctrans_torch.data.synthetic import nuclei_scene_rule
    from pctrans_torch.engine.evaluator import Evaluator

    cvppp = list(scene_batches(N_EVAL_BATCHES, SEED + 1))
    k = pipelined_vs_serial("CVPPP", Evaluator(build_model(CVPPP_RECIPE, dev), top_k=50),
                            cvppp, card)
    n_inst, radius = nuclei_scene_rule(BBBC_HW)
    bbbc = list(scene_batches(N_EVAL_BATCHES, SEED + 3, BBBC_BATCH, BBBC_HW,
                              n_instances=n_inst, radius_px=radius))
    pipelined_vs_serial("BBBC", Evaluator(build_model(BBBC_RECIPE, dev), top_k=BBBC_TOP_K,
                                          dataset="bbbc"), bbbc, card)
    return k


def submission_phase(dev, card):
    """Phase 12: ``test_cvppp``'s generator over a synthetic CVPPP test
    split (two batches of four 530x500 scenes, rgb and fg, no labels;
    the last batch padded as the loader pads it), through the pipeline and
    ``merge_func``; ``submission.h5`` written where h5py imports."""
    from pctrans_torch.config import load_cfg
    from pctrans_torch.data.cvppp import TEST_PLANTS
    from pctrans_torch.engine.trainer import Trainer, write_submission
    from pctrans_torch.ops.msdeform import ms_deform_attn
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    batches = []
    for b in scene_batches(2, SEED + 5, BATCH, IMAGE_HW):
        batches.append({"image": b["image"], "fg": (b["label"] > 0).astype(np.int32)})
    batches[-1]["_num_valid"] = np.int32(BATCH - 1)
    cfg = load_cfg(str(REPO / "configs/CVPPP/CVPPP-PCTrans-Base.yaml"),
                   str(REPO / "configs/CVPPP/CVPPP-PCTrans.yaml"),
                   ["DATASET.DATA_TYPE", "synthetic"])
    trainer = Trainer(cfg, mode="test", device=dev)
    counters = (ms_deform_attn, dynamic_mask_render, resize_bilinear_binarize)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    preds = list(trainer.cvppp_submission(loader=batches))
    wall = time.perf_counter() - t0
    launches, fwd = [c.launches for c in counters], trainer.evaluator.forwards
    valid = [(b, i) for b in batches for i in range(int(b.get("_num_valid", BATCH)))]
    print(f"12 test_cvppp over {len(valid)} synthetic test plants: {wall:.3f} s, {fwd} "
          f"forwards, launches K1 {launches[0]}, K3 {launches[1]}, K4 {launches[2]}; "
          "instances per plant " + " ".join(f"{p}:{int(s.max())}" for p, s in preds)
          + f", on {card}")
    if [p for p, _ in preds] != TEST_PLANTS[:len(valid)] or \
            launches != [6 * fwd, 10 * fwd, fwd] or \
            any(s.dtype != np.uint8 or s.shape != IMAGE_HW or s[b["fg"][i] == 0].any()
                for (_, s), (b, i) in zip(preds, valid)):
        raise AssertionError("12: the submission is not the test split's")
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("12 h5py does not import here: submission.h5 not written "
              "(write_submission raises an ImportError that names it)")
        return launches
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        n = write_submission(f"{tmp}/submission.h5", iter(preds))
        print(f"12 submission.h5 written: {n} plants")
    return launches


def monitoring_phase(card):
    """Phase 13: ``scripts/main_torch.py`` with the CVPPP YAMLs on synthetic
    data, MONITOR.PROFILE_ITERS [2, 3] and a validation at the end: the
    Chrome trace under OUTPUT_PATH/profile holds K1 and K2 kernel events,
    and the validation panels are PNG files.  A trace that kept no K1 or K2
    event (the profiler here loses events, now and then all of them) is set
    aside and the run made again, at most MONITOR_TRIES times."""
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward

    sys.path.insert(0, str(REPO / "scripts"))
    import main_torch

    for attempt in range(MONITOR_TRIES):
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            cfg_args, opts = cvppp_entry_args(tmp)
            opts += ["SOLVER.ITERATION_TOTAL", str(MONITOR_ITERS), "SOLVER.ITERATION_VAL",
                     str(MONITOR_ITERS), "SOLVER.ITERATION_SAVE", str(MONITOR_ITERS),
                     "MONITOR.PROFILE_ITERS", "[2, 3]"]
            for c in (ms_deform_attn, ms_deform_attn_backward):
                c.launches = 0
            t0 = time.perf_counter()
            trainer = main_torch.main(cfg_args + ["--opts", *opts])
            wall = time.perf_counter() - t0
            traces = sorted(Path(tmp, "profile").glob("*.json"))
            pngs = sorted(p.name for p in Path(tmp, "vis").glob("*.png"))
            events = json.loads(traces[0].read_text())["traceEvents"] if traces else []
            kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
            k1 = sum("msdeform_fwd_kernel" in n for n in kernels)
            k2 = sum("msdeform_bwd_kernel" in n for n in kernels)
            print(f"13 main_torch.py, PROFILE_ITERS [2, 3], {MONITOR_ITERS} iterations: "
                  f"trace {[t.name for t in traces]} with {len(kernels)} kernel events, K1 "
                  f"{k1}, K2 {k2} (launched over the run K1 {ms_deform_attn.launches}, K2 "
                  f"{ms_deform_attn_backward.launches}); validation panels {pngs}; wall "
                  f"{wall:.3f} s, on {card}")
            if not pngs or len(traces) != 1 or trainer.monitor.trace_path != str(traces[0]):
                raise AssertionError("13: the trace or the panels were not written")
            if k1 and k2:
                return
        print(f"13 run {attempt + 1} of at most {MONITOR_TRIES} set aside: its trace kept "
              "no K1 or no K2 event")
    raise AssertionError(f"13: {MONITOR_TRIES} traces without K1 and K2 events")


# ---------------------------------------------------------- phase 6: dtypes
DTYPE_MAP_HW = (64, 64)        # a module's output dtype does not depend on the size
# the recipe's stages whose dtypes phase 6 prints (JAX's: ROADMAP §C.18)
DTYPE_STAGES = ("backbone", "pixel_decoder.input_gn.0", "pixel_decoder.encoder_layer.0.norm1",
                "pixel_decoder.adapter.0", "pixel_decoder.layer.0", "predictor.ref_point_head",
                "predictor.controller", "predictor.mask_head", "predictor.seg_head.1",
                "predictor.sem_logits", "predictor.cross_layers.0", "predictor.ffn_layers.0",
                "predictor.decoder_norm")


def dtype_map_phase(dev, card) -> None:
    """The bf16 dtype map (``module_dtypes``: every module's output dtypes)
    of the CVPPP recipe, of Swin-T and of each of ``ALT_COMBINATIONS``, in
    eval and in train mode, on the card and on a CPU copy with the same
    weights, at 64x64: CUDA and CPU autocast list other ops, so the port
    fixes each dtype in its module, and any module whose dtype differs
    between the two fails the phase."""
    import collections
    import copy

    from pctrans_torch.config import CVPPP_RECIPE
    from pctrans_torch.models.pctrans import module_dtypes

    x = torch.from_numpy(next(scene_batches(1, SEED + 7, batch=1, hw=DTYPE_MAP_HW))["image"])
    configs = [("CVPPP", CVPPP_RECIPE), ("Swin-T", swin_recipe())] + [
        (name, dataclasses.replace(CVPPP_RECIPE, **over)) for name, over in ALT_COMBINATIONS]
    for name, config in configs:
        model = build_model(config, dev)
        for mode in ("eval", "train"):
            train = mode == "train"
            on_card = module_dtypes(copy.deepcopy(model).train(train), x.to(dev))
            on_cpu = module_dtypes(copy.deepcopy(model).cpu().train(train), x)
            differ = sorted(n for n in set(on_card) | set(on_cpu)
                            if on_card.get(n) != on_cpu.get(n))
            counts = collections.Counter(on_card.values())
            print(f"bf16 {name} dtype map, {mode} mode: {len(on_card)} modules, "
                  + "; ".join(f"{n} x {sig}" for sig, n in counts.most_common(3))
                  + f"; {len(differ)} differ between the card and the CPU, on {card}")
            if config is CVPPP_RECIPE:
                print("  stages: " + ", ".join(f"{n} {on_card[n]}" for n in DTYPE_STAGES))
            if differ:
                raise AssertionError(
                    f"{name}, {mode}-mode dtypes differ between the card and the CPU: "
                    + ", ".join(f"{n} card {on_card.get(n)} cpu {on_cpu.get(n)}"
                                for n in differ[:20]))
        del model


# ------------------------------------------------- phase 14: on-disk trees
FIXTURE_ITERS = 2              # iterations of each main_torch.py run of phase 14 (c)


def cvppp_yamls():
    return ["--config-base", str(REPO / "configs/CVPPP/CVPPP-PCTrans-Base.yaml"),
            "--config-file", str(REPO / "configs/CVPPP/CVPPP-PCTrans.yaml")]


def bbbc_yamls():
    return ["--config-base", str(REPO / "configs/BBBC/BBBC-PCTrans-Base.yaml"),
            "--config-file", str(REPO / "configs/BBBC/BBBC-PCTrans.yaml")]


def fixture_phase(card, ckpts: Path):
    """Phase 14: fixture trees in the CVPPP A1 and BBBC039 layouts, written
    by ``pctrans_torch.data.fixtures`` on this machine, through the on-disk
    readers: (a) ``scan_dataset_torch.py`` over both; (b)
    ``eval_torch.py`` with the published YAMLs and DATA_TYPE CVPPP / BBBC
    over phase 8's checkpoints in ``ckpts`` (the CVPPP val split by
    SBD/|DiC|, the BBBC test split by AJI/PQ; then BBBC's validation split
    through the Trainer): K1 = 6, K3 = 10, K4 = 1 per forward; (c)
    ``main_torch.py`` with DATA_TYPE CVPPP, then BBBC, FIXTURE_ITERS
    iterations over the train split with the train-time augmentations (cv2)
    and a validation: K1 = 6 per step and forward, K2 = 6 per step.
    Returns the launches [(K1, K2, K3, K4) of (b) CVPPP, (b) BBBC, (c)
    CVPPP, (c) BBBC]."""
    import importlib

    probe = []
    for name in ("PIL", "cv2"):
        try:
            probe.append(f"{name} {importlib.import_module(name).__version__}")
        except ImportError as e:
            probe.append(f"{name} does not import ({e})")
    print("phase 14 probe: " + ", ".join(probe))
    from pctrans_torch.data.build import build_dataloader
    from pctrans_torch.data.fixtures import write_bbbc_fixture, write_cvppp_fixture
    from pctrans_torch.engine import checkpoint as ckpt
    from pctrans_torch.engine.trainer import Trainer
    from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_backward
    from pctrans_torch.ops.render import dynamic_mask_render
    from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

    sys.path.insert(0, str(REPO / "scripts"))
    import eval_torch
    import main_torch
    import scan_dataset_torch

    counters = (ms_deform_attn, ms_deform_attn_backward, dynamic_mask_render,
                resize_bilinear_binarize)
    runs = []
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        t0 = time.perf_counter()
        trees = {"CVPPP": (f"{tmp}/cvppp", cvppp_yamls(), write_cvppp_fixture(
                     f"{tmp}/cvppp", n_train=4, n_val=4, n_test=1, size=IMAGE_HW,
                     seed=SEED)),
                 "BBBC": (f"{tmp}/bbbc", bbbc_yamls(), write_bbbc_fixture(
                     f"{tmp}/bbbc", n_train=2, n_val=2, n_test=2, size=BBBC_HW,
                     seed=SEED))}
        print(f"fixture trees written in {time.perf_counter() - t0:.2f} s: "
              + "; ".join(f"{k} {dict((s, len(n)) for s, n in v[2].items())}"
                          for k, v in trees.items()))
        for dt, (root, yamls, _) in trees.items():                       # (a)
            for mode in ("train", "val", "test") if dt == "BBBC" else ("train", "val"):
                print(f"(a) scan_dataset_torch.py, {dt} {mode}:")
                scan_dataset_torch.main(yamls + ["--mode", mode, "--samples", "6", "--opts",
                                                 "DATASET.DATA_TYPE", dt,
                                                 "DATASET.INPUT_PATH", root])

        def counted(name, fn, metrics, forwards_only):
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            out = fn()
            wall = time.perf_counter() - t0
            k1, k2, k3, k4 = [c.launches for c in counters]
            print(f"{name}: {out}; launches K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4}; "
                  f"wall {wall:.3f} s, on {card}")
            records = out if isinstance(out, list) else [out]
            if not records or not all(math.isfinite(r[k]) for r in records for k in metrics):
                raise AssertionError(f"{name}: metrics {out}")
            if forwards_only and (k4 < 1 or [k1, k2, k3] != [6 * k4, 0, 10 * k4]):
                raise AssertionError(f"{name}: launch counts do not match its forwards")
            runs.append((k1, k2, k3, k4))
            return out

        for dt, metrics in (("CVPPP", ("SBD", "absDiffFG")),                # (b)
                            ("BBBC", ("AJI", "F1", "detF1", "PQ"))):
            root, yamls, _ = trees[dt]
            opts = ["DATASET.DATA_TYPE", dt, "DATASET.INPUT_PATH", root,
                    "DATASET.OUTPUT_PATH", str(ckpts / dt),
                    "INFERENCE.OUTPUT_PATH", f"{tmp}/eval_{dt}"]
            counted(f"(b) eval_torch.py, {dt} over {root}",
                    lambda: eval_torch.main(yamls + ["--start", "0", "--opts", *opts]),
                    metrics, True)
        root, yamls, _ = trees["BBBC"]
        from pctrans_torch.config import load_cfg, update_inference_cfg
        cfg = update_inference_cfg(load_cfg(*yamls[1::2], [
            "DATASET.DATA_TYPE", "BBBC", "DATASET.INPUT_PATH", root,
            "INFERENCE.OUTPUT_PATH", f"{tmp}/val_BBBC"], freeze=False))
        trainer = Trainer(cfg, mode="test")
        ckpt.restore_checkpoint(ckpt.list_checkpoints(str(ckpts / "BBBC"))[-1], trainer.model)
        loader = build_dataloader(cfg, "val")
        try:
            counted("(b) the BBBC validation split through Trainer.test_bbbc",
                    lambda: trainer.test_bbbc(loader=loader), ("AJI", "F1", "detF1", "PQ"),
                    True)
        finally:
            loader.close()

        for dt, metrics in (("CVPPP", ("SBD", "absDiffFG")),                # (c)
                            ("BBBC", ("AJI", "PQ"))):
            root, yamls, _ = trees[dt]
            out = f"{tmp}/train_{dt}"
            opts = ["DATASET.DATA_TYPE", dt, "DATASET.INPUT_PATH", root,
                    "SOLVER.ITERATION_TOTAL", str(FIXTURE_ITERS),
                    "SOLVER.ITERATION_SAVE", str(FIXTURE_ITERS), "SOLVER.START_SAVE", "0",
                    "SOLVER.ITERATION_VAL", str(FIXTURE_ITERS), "DATASET.OUTPUT_PATH", out,
                    "INFERENCE.OUTPUT_PATH", f"{out}/test", "MONITOR.TENSORBOARD", "False",
                    "MONITOR.ITERATION_NUM", "[1, 200]"]
            holder = {}

            def train(yamls=yamls, opts=opts):
                holder["t"] = main_torch.main(yamls + ["--opts", *opts])
                lines = [json.loads(l) for l in Path(out, "metrics.jsonl").read_text()
                         .splitlines()]
                return [r["eval"] for r in lines if "eval" in r]

            counted(f"(c) main_torch.py, {dt} train split, {FIXTURE_ITERS} iterations "
                    "+ a validation", train, metrics, False)
            k1, k2, k3, k4 = runs[-1]
            fwd = holder["t"].evaluator.forwards
            if [k1, k2, k3, k4] != [6 * (FIXTURE_ITERS + fwd), 6 * FIXTURE_ITERS, 10 * fwd, fwd]:
                raise AssertionError(f"(c) {dt}: launch counts do not match the run")
            saved = sorted(f for f in os.listdir(out) if f.endswith(".pth.tar"))
            if f"checkpoint_{FIXTURE_ITERS:06d}.pth.tar" not in saved:
                raise AssertionError(f"(c) {dt}: checkpoints {saved}")
    return runs


# ------------------------------------------------ phase 15: legacy U-Nets
# the four U-Nets at build_architecture's defaults (FILTERS [28, 36, 48, 64,
# 80], ISOTROPY [F, F, F, T, T], residual blocks, elu, replicate, bn) on one
# channel
LEGACY_SHAPES = {"unet_3d": (2, 1, 8, 256, 256), "unet_plus_3d": (2, 1, 8, 256, 256),
                 "unet_2d": (2, 1, 256, 256), "unet_plus_2d": (2, 1, 256, 256)}
LEGACY_STEPS = 3               # timed steps after the first (compared) one
# the card's f32 step (TF32 off) against the CPU's f64 step; BatchNorm's
# batch statistics and the Dice sums reduce over ~1e6 voxels in f32
LEGACY_RTOL = 1e-5


def legacy_criterion(target: str = "0"):
    """Two terms for ``target`` ("0" binary, one channel; "2" affinity,
    three): WeightedBCEWithLogitsLoss on the logits and DiceLoss on their
    sigmoid."""
    from pctrans_torch.losses.legacy import LegacyCriterion

    return LegacyCriterion([target], [["WeightedBCEWithLogitsLoss", "DiceLoss"]],
                           [["none", "sigmoid"]], [[1.0, 1.0]])


def conv_gflop(model, x) -> float:
    """GFLOP of the convolutions of one forward of ``model`` on ``x``: 2 x
    each output element x its input channels per group x the kernel's
    taps, from the shapes (a step's backward adds about twice that)."""
    total = []

    def count(m, inputs, out):
        total.append(2.0 * out.numel() * m.weight[0].numel())

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return sum(total) / 1e9


def grad_norm(model) -> torch.Tensor:
    """The gradient's global norm, summed in f64: an f32 norm of a tensor of
    millions of elements on the CPU can lie ~1e-4 from the exact one
    (``pctrans_torch.models.legacy.step_precision`` prints both)."""
    return torch.linalg.vector_norm(torch.stack(
        [p.grad.double().norm() for p in model.parameters() if p.grad is not None]))


def legacy_step(model, opt, crit, x, target, weights=None):
    """Forward, the criterion (``weights``: its per-term weight maps),
    backward, the gradient's global norm, one optimizer step; (loss,
    {term: value}, grad norm) before the update."""
    opt.zero_grad(set_to_none=True)
    loss, terms = crit(model(x), [target], weights)
    loss.backward()
    norm = grad_norm(model)
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in terms.items()}, norm


def gan_step(model, opt, fake, real):
    """One discriminator step under ``GANLoss`` (lsgan): the mean of the
    real and the fake terms; (loss, terms, grad norm) before the update."""
    from pctrans_torch.losses.legacy import GANLoss

    gan = GANLoss()
    opt.zero_grad(set_to_none=True)
    terms = {"real": gan(model(real), True), "fake": gan(model(fake), False)}
    loss = 0.5 * (terms["real"] + terms["fake"])
    loss.backward()
    norm = grad_norm(model)
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in terms.items()}, norm


def card_vs_cpu(name, model, solver, step, inputs, dev, card, grad_rtol=LEGACY_RTOL,
                n_steps=LEGACY_STEPS) -> dict:
    """``step(model, optimizer, *inputs)`` once in f64 on a CPU copy of
    ``model`` (the reference) and once in f32 on the card from the same
    weights: the card's loss and each term within ``LEGACY_RTOL`` of the
    reference, its gradient norm within ``grad_rtol``.  The model's own
    f32 casts (its output, BotNet's softmax) stay in the f64 copy.  Then
    ``n_steps`` more f32 steps of the same model on the card, timed with
    CUDA events, the peak memory above what the card held before the model
    came, and the convolutions' GFLOP per step (three forwards' worth,
    counted on the card) with the rate they imply.  Returns the record;
    the model stays on the card."""
    import copy

    from pctrans_torch.engine.solver import build_optimizer

    cpu_model = copy.deepcopy(model).double().train()
    t0 = time.perf_counter()
    ref = step(cpu_model, build_optimizer(cpu_model, solver), *[t.double() for t in inputs])
    cpu_s = time.perf_counter() - t0
    del cpu_model
    held = torch.cuda.memory_allocated()
    model = model.to(dev).train()
    opt = build_optimizer(model, solver)
    on_card = [t.to(dev) for t in inputs]
    gflop = 3 * conv_gflop(copy.deepcopy(model).eval(), on_card[0])
    torch.cuda.reset_peak_memory_stats()
    first = step(model, opt, *on_card)
    errs = {k: abs(float(x) - float(y)) / abs(float(y)) for k, x, y in
            [("loss", first[0], ref[0]), ("grad_norm", first[2], ref[2])]
            + [(k, first[1][k], ref[1][k]) for k in ref[1]]}
    start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start_ev.record()
    for _ in range(n_steps):
        last = step(model, opt, *on_card)
    end_ev.record()
    end_ev.synchronize()
    ms = start_ev.elapsed_time(end_ev) / n_steps
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{name} {list(inputs[0].shape)}, {n_params} parameters: f32 loss on the card "
          f"{float(first[0]):.6f} (f64 CPU {float(ref[0]):.6f}), grad norm "
          f"{float(first[2]):.6f} (f64 CPU {float(ref[2]):.6f}), rel diffs "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (<= {LEGACY_RTOL}, grad_norm {grad_rtol}); {ms:.3f} ms per f32 step "
          f"(CUDA events, {n_steps} steps; ~{gflop:.1f} GFLOP of convolutions per step, "
          f"{gflop / ms:.2f} TFLOP/s), peak {peak:.3f} GiB above the start, loss after "
          f"{n_steps + 1} steps {float(last[0]):.6f}; f64 CPU step {cpu_s:.2f} s; on {card}")
    bounds = {k: grad_rtol if k == "grad_norm" else LEGACY_RTOL for k in errs}
    if any(errs[k] > bounds[k] for k in errs) or not math.isfinite(float(last[0])):
        raise AssertionError(f"{name}: the card's f32 step is not the CPU's f64 step")
    return {"ms": ms, "peak_gib": peak, "conv_gflop": gflop, **errs}


def legacy_phase(dev, card) -> dict:
    """Phase 15: each U-Net from ``build_architecture`` trains one f32 step
    (forward, the two-term ``LegacyCriterion``, backward, AdamW) on the
    card and in f64 on a CPU copy with the same weights and batch
    (``card_vs_cpu``),
    then ``LEGACY_STEPS`` more on the card; printed with the convolutions'
    GFLOP per step (three forwards' worth) and the rate they imply.  No
    kernel of the repo runs here: the TPU package has no Pallas kernel on
    this path."""
    import gc

    from pctrans_torch.config import get_cfg_defaults
    from pctrans_torch.engine.solver import build_solver_config
    from pctrans_torch.models import build_architecture

    crit = legacy_criterion()
    out = {}
    before_gc = torch.cuda.memory_allocated()
    gc.collect()
    print(f"phase 15 starts with {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated "
          f"on the card ({before_gc / 2 ** 30:.3f} before gc.collect())")
    for arch, shape in LEGACY_SHAPES.items():
        cfg = get_cfg_defaults()
        cfg.MODEL.ARCHITECTURE = arch
        cfg.MODEL.IN_PLANES = shape[1]
        model = build_architecture(cfg, torch.Generator().manual_seed(SEED))
        rng = np.random.RandomState(SEED)
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        target = torch.from_numpy((rng.rand(*shape) > 0.7).astype(np.float32))
        out[arch] = card_vs_cpu(arch, model, build_solver_config(cfg),
                                lambda m, o, x, t: legacy_step(m, o, crit, x, t),
                                (x, target), dev, card)
    return out


# ------------------------------------------ phase 16: the rest of the legacy zoo
ZOO_3D = (2, 1, 8, 256, 256)
ZOO_2D = (2, 1, 256, 256)
# (name, MODEL.ARCHITECTURE, the MODEL keys that pick the variant, input);
# the rest at build_architecture's defaults (FILTERS [28, 36, 48, 64, 80],
# BLOCKS [2, 2, 2, 2], ISOTROPY [F, F, F, T, T], elu, replicate, bn) with
# three output channels, the affinity width of the EM recipes
ZOO = [("fpn_3d resnet", "fpn_3d", {"BACKBONES": "resnet"}, ZOO_3D),
       ("fpn_3d repvgg", "fpn_3d", {"BACKBONES": "repvgg"}, ZOO_3D),
       ("fpn_3d botnet", "fpn_3d", {"BACKBONES": "botnet"}, ZOO_3D),
       ("fpn_3d efficientnet", "fpn_3d", {"BACKBONES": "efficientnet"}, ZOO_3D),
       ("unet_residual_3d", "unet_residual_3d", {}, ZOO_3D),
       ("deeplabv3a + aux", "deeplabv3a", {"AUX_OUT": True}, ZOO_2D),
       ("deeplabv3b", "deeplabv3b", {}, ZOO_2D),
       ("deeplabv3c", "deeplabv3c", {}, ZOO_2D)]
ZOO_OUT = 3
# DeepLab's gradient norm at batch 2 against the CPU's f64 step: its f32
# gradient is ill-conditioned (the parameter farthest from f64 on every
# device is the backbone's last BatchNorm bias, 2e-4 to 8e-4), and cuDNN's
# f32 kernels add to that.  Read on an H100 (``python3 -m
# pctrans_torch.models.legacy.step_precision``): cuDNN 1.34e-4 to 1.82e-4,
# PyTorch's im2col convolutions 1.7e-5 to 5.0e-5, the CPU's f32 step 2e-6
# to 6.2e-5, TF32 3.0e-2 to 9.3e-2.  The loss and its terms keep LEGACY_RTOL.
GRAD_RTOL = {"deeplabv3a": 5e-4, "deeplabv3b": 5e-4, "deeplabv3c": 5e-4}
# the fused deploy conv against the three branches, both f32 on the card
DEPLOY_RTOL = 1e-5


def zoo_model(arch: str, keys: dict, shape):
    """``build_architecture``'s model for ``arch`` at an input of ``shape``
    (IN_PLANES and INPUT_SIZE from it), with seeded weights."""
    from pctrans_torch.config import get_cfg_defaults
    from pctrans_torch.models import build_architecture

    cfg = get_cfg_defaults()
    cfg.MODEL.ARCHITECTURE = arch
    cfg.MODEL.IN_PLANES, cfg.MODEL.OUT_PLANES = shape[1], ZOO_OUT
    cfg.MODEL.INPUT_SIZE = list(shape[2:])
    for k, v in keys.items():
        setattr(cfg.MODEL, k, v)
    return build_architecture(cfg, torch.Generator().manual_seed(SEED))


def zoo_phase(dev, card) -> dict:
    """Phase 16: the rest of the zoo from ``build_architecture`` (``ZOO``):
    one f32 step each (the two-term affinity ``LegacyCriterion``; DeepLab's
    over its ``out`` and ``aux`` maps; gradient norms within ``GRAD_RTOL``)
    on the card against an f64 CPU copy (``card_vs_cpu``) and ``LEGACY_STEPS``
    timed; the repvgg FPN3D
    converted to deploy (``repvgg_convert``), its eval forward on the card
    against the train-mode model's eval forward; then ``Discriminator3D``
    at its defaults on ``unet_residual_3d``'s output, one ``GANLoss`` step
    card against CPU alike.  No kernel of the repo runs here."""
    import gc

    from pctrans_torch.config import get_cfg_defaults
    from pctrans_torch.engine.solver import build_solver_config
    from pctrans_torch.models.legacy import (Discriminator3D, init_legacy_weights,
                                             repvgg_convert)

    crit = legacy_criterion("2")
    solver = build_solver_config(get_cfg_defaults())
    out = {}
    gc.collect()
    for name, arch, keys, shape in ZOO:
        model = zoo_model(arch, keys, shape)
        rng = np.random.RandomState(SEED)
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        target = torch.from_numpy(
            (rng.rand(shape[0], ZOO_OUT, *shape[2:]) > 0.7).astype(np.float32))
        out[name] = card_vs_cpu(name, model, solver,
                                lambda m, o, x, t: legacy_step(m, o, crit, x, t),
                                (x, target), dev, card, GRAD_RTOL.get(arch, LEGACY_RTOL))
        if arch == "unet_residual_3d":
            with torch.no_grad():
                fake = model.eval()(x.to(dev)).cpu()
        if keys.get("BACKBONES") == "repvgg":
            model.eval()
            deploy = repvgg_convert(model)
            with torch.no_grad():
                xd = x.to(dev)
                err = rel_fro(deploy(xd), model(xd))
            print(f"{name} deploy (repvgg_convert) eval forward against the train-mode "
                  f"model's: rel-Fro {err:.3e} (<= {DEPLOY_RTOL}); on {card}")
            if not err <= DEPLOY_RTOL:
                raise AssertionError(f"{name}: the deploy conversion is not the model")
            out[name]["deploy_rel_fro"] = err
            del deploy
        del model
    disc = Discriminator3D(in_channel=fake.shape[1])
    init_legacy_weights(disc, torch.Generator().manual_seed(SEED))
    real = torch.from_numpy(
        (np.random.RandomState(SEED + 1).rand(*fake.shape) > 0.7).astype(np.float32))
    out["Discriminator3D"] = card_vs_cpu(
        "Discriminator3D (GANLoss lsgan) on unet_residual_3d's output", disc, solver,
        gan_step, (fake, real), dev, card)
    return out


# ------------------------------------------ phase 17: volume data into a 3D model
EM_SHAPE = (100, 1024, 1024)      # SNEMI3D's stack, the reference recipe's volume
EM_IDS = 400                      # neurites in the volume
EM_SAMPLE = [8, 256, 256]         # MODEL.INPUT_SIZE / OUTPUT_SIZE of the phase
EM_DRAWS = 32


def volume_phase(dev, card) -> dict:
    """Phase 17: an SNEMI3D-sized volume (``EM_SHAPE``, ``EM_IDS`` ids)
    written here (image PNG stack, labels multi-page TIFF) and read through
    ``get_dataset(cfg, "train")`` with DATA_TYPE volume and the default
    augmentor: samples/s over ``EM_DRAWS`` draws, each sample's shapes and
    dtypes, two draws from one seed equal (else the phase fails), the
    checksum of the seeded sample of ``fixtures.write_em_checksum_volume``
    (printed beside the one the CPU test records under cv2 5.0, not gated:
    the card's machine has another cv2);
    one fpn_3d resnet f32 step on a batch of two samples on the card; then
    ``mode="val"`` grid sampling and a ``TileDataset`` over a two-tile JSON
    layout of the volume's first rows."""
    import cv2

    from pctrans_torch.config import load_cfg
    from pctrans_torch.data import fixtures
    from pctrans_torch.data.build import build_volume_dataset, get_dataset
    from pctrans_torch.engine.solver import build_optimizer, build_solver_config

    out = {}
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        image, label = fixtures.em_volume(EM_SHAPE, SEED, EM_IDS)
        t1 = time.perf_counter()
        fixtures.write_em_volume(root, image, label)
        t2 = time.perf_counter()
        cfg = load_cfg(opts=fixtures.em_volume_opts(tmp, EM_SAMPLE))
        ds = get_dataset(cfg, "train")
        t3 = time.perf_counter()
        n_ids = int(np.count_nonzero(np.bincount(label.ravel())[1:]))
        print(f"phase 17: volume {list(EM_SHAPE)} with {n_ids} ids "
              f"made in {t1 - t0:.2f} s, written in {t2 - t1:.2f} s (PNG stack, cv2 "
              f"{cv2.__version__}; u16 TIFF, PIL), read by get_dataset in {t3 - t2:.2f} s: "
              f"image {ds.volume[0].dtype} {list(ds.volume[0].shape)}, labels "
              f"{ds.label[0].dtype} {list(ds.label[0].shape)}, crop "
              f"{list(ds.aug_sample_size)} before the augmentor's centre crop")
        if not (np.array_equal(ds.volume[0], image) and np.array_equal(ds.label[0], label)):
            raise AssertionError("phase 17: the volume read back is not the one written")
        del image
        t0 = time.perf_counter()
        samples = [ds.__getitem__(i, rng=np.random.RandomState(SEED + i))
                   for i in range(EM_DRAWS)]
        rate = EM_DRAWS / (time.perf_counter() - t0)
        print(f"{EM_DRAWS} draws: {rate:.3f} samples/s (host, one thread); sample "
              + ", ".join(f"{k} {v.dtype} {list(v.shape)}" for k, v in samples[0].items()))
        again = ds.__getitem__(0, rng=np.random.RandomState(SEED))
        same = all(np.array_equal(again[k], samples[0][k]) for k in samples[0])
        print(f"two draws from seed {SEED} equal: {same}")
        if not same:
            raise AssertionError("phase 17: two draws from one seed differ")
        opts = fixtures.write_em_checksum_volume(root / "checksum", SEED)
        checksum = fixtures.sample_checksum(build_volume_dataset(
            load_cfg(opts=opts), "train").__getitem__(0, rng=np.random.RandomState(SEED)))
        recorded = fixtures.EM_CHECKSUM_CV2_5
        print(f"checksum of the seeded augmented sample: {checksum} under cv2 "
              f"{cv2.__version__}; under cv2 5.0.0 on the CPU: {recorded} "
              f"({'match' if checksum == recorded else 'mismatch'}; not gated)")
        out.update(samples_per_s=rate, checksum=checksum, checksum_match=checksum == recorded)

        model = zoo_model("fpn_3d", {"BACKBONES": "resnet"}, (2, 1, *EM_SAMPLE))
        model = model.to(dev).train()
        opt = build_optimizer(model, build_solver_config(cfg))
        batch = {k: torch.from_numpy(np.stack([s[k] for s in samples[:2]])).to(dev)
                 for k in samples[0]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # WEIGHT_OPT [["1"]]: the binary-ratio weights on the first term
        loss, terms, norm = legacy_step(model, opt, legacy_criterion("2"), batch["image"],
                                        batch["target_0"], [[batch["weight_0_0"], None]])
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        print(f"fpn_3d resnet on a batch of two samples: loss {float(loss):.6f} ("
              + ", ".join(f"{k} {float(v):.6f}" for k, v in terms.items())
              + f"), grad norm {float(norm):.6f}, one f32 step {step_ms:.1f} ms (host "
              f"clock, the first); on {card}")
        if not (math.isfinite(float(loss)) and math.isfinite(float(norm))):
            raise AssertionError("phase 17: the step is not finite")
        out["step_ms"] = step_ms
        del model, opt, batch, samples

        val = get_dataset(cfg, "val")
        items = [val[0], val[len(val) - 1]]
        print(f"val grid: {len(val)} windows of {EM_SAMPLE}; first pos "
              f"{items[0]['pos'].tolist()}, last {items[1]['pos'].tolist()}, image "
              f"{items[1]['image'].dtype} {list(items[1]['image'].shape)}")
        if len(val) < 2 or any(it["image"].shape != (1, *EM_SAMPLE) for it in items):
            raise AssertionError("phase 17: the val grid")

        tile = EM_SHAPE[1] // 2
        names = fixtures.write_em_tiles(root, ds.volume[0], ds.label[0], tile)
        tcfg = load_cfg(opts=fixtures.em_volume_opts(tmp, EM_SAMPLE) + [
            "DATASET.DO_CHUNK_TITLE", "1", "DATASET.IMAGE_NAME", names["im"],
            "DATASET.LABEL_NAME", names["seg"], "DATASET.DATA_CHUNK_NUM", "[1, 1, 2]",
            "DATASET.DATA_CHUNK_STRIDE", "False"])
        tiles = get_dataset(tcfg, "train")
        for _ in range(len(tiles)):
            tiles.updatechunk()
            inner = tiles.dataset
            it = inner.__getitem__(0, rng=np.random.RandomState(SEED))
            print(f"TileDataset chunk {tiles.get_coord_name()}: volume "
                  f"{list(inner.volume[0].shape)}, sample " + ", ".join(
                      f"{k} {list(v.shape)}" for k, v in it.items()))
            if it["target_0"].shape != (3, *EM_SAMPLE):
                raise AssertionError("phase 17: the tile dataset's sample")
        out["tile_chunks"] = len(tiles)
    return out


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
    k7_gate = gate_mask_stats(dev, g)
    k8_gate = gate_label_pairs(dev, g)
    slice_f32(dev)
    train_f32_backward(dev)
    (k1_eval, k3, k4, k7, k8), k1_model, k5_model, _ = slice_bf16(dev, card)
    k1_gate.update(k1_model)
    k5_gate.update(k5_model)
    dtype_map_phase(dev, card)
    bbbc_eval = slice_bbbc(dev, card)
    (k1, k2, _), k2_model = train_bf16(dev, card)
    k2_gate.update(k2_model)
    sampled = train_sampled_modes(dev, card)
    ckpts = tempfile.TemporaryDirectory(dir=REPO / "build")
    k5, phase8_train = entry_points(card, Path(ckpts.name, "CVPPP"))
    bbbc_entry = entry_points_bbbc(card, Path(ckpts.name, "BBBC"))
    settings_train, settings_eval = entry_points_settings(card)
    swin_eval, k1_swin, swin_train, k2_swin, k6_gate = swin_phase(dev, card)
    k1_gate.update({f"swin_{k}": v for k, v in k1_swin.items()})
    k2_gate.update({f"swin_{k}": v for k, v in k2_swin.items()})
    swin_entry, swin_sweep = entry_points_swin(card)
    alt_eval, swap = alt_combinations(dev, card)
    gates[2].update({f"swap_{k[3:]}": v for k, v in swap.items() if k.startswith("k3_")})
    gates[3].update({f"swap_{k[3:]}": v for k, v in swap.items() if k.startswith("k4_")})
    dist_run, dist_ranks = distributed_phase(dev, card, phase8_train)
    pipelined = pipeline_phase(dev, card)
    submission = submission_phase(dev, card)
    monitoring_phase(card)
    fixture_runs = fixture_phase(card, Path(ckpts.name))
    ckpts.cleanup()
    legacy = legacy_phase(dev, card)
    t0 = time.perf_counter()
    zoo = zoo_phase(dev, card)
    t1 = time.perf_counter()
    volume = volume_phase(dev, card)
    print(f"phase 16 took {t1 - t0:.1f} s, phase 17 {time.perf_counter() - t1:.1f} s; "
          f"the rest of the zoo (phase 16) {json.dumps(zoo)}; volume data (phase 17) "
          f"{json.dumps(volume)}")
    print(f"on-disk trees (phase 14) K1, K2, K3, K4: eval CVPPP, eval BBBC test, BBBC "
          f"validation, train CVPPP, train BBBC {fixture_runs}; legacy U-Nets (phase 15) "
          + json.dumps(legacy))
    print(f"new paths: distributed world 1 (phase 8's run) K5, K1, K2 {dist_run}; two gloo "
          f"ranks K1, K2 per rank {dist_ranks}; pipelined CVPPP eval K1, K3, K4 {pipelined}; "
          f"test_cvppp K1, K3, K4 {submission}")
    gates[0]["dist_rank_launches"] = [r[0] for r in dist_ranks]
    gates[1]["dist_rank_launches"] = [r[1] for r in dist_ranks]
    for gate, n in zip((gates[0], gates[2], gates[3]), pipelined):
        gate["pipeline_launches"] = n
    print(f"main paths: train K1 {k1}, K2 {k2}; eval K1 {k1_eval}, K3 {k3}, "
          f"K4 {k4}, K7 {k7}, K8 {k8}; BBBC eval "
          f"K1, K3, K4, K7, K8 {bbbc_eval}; BBBC entry points K1, K2, K3, K4 {bbbc_entry}; "
          f"sampled point modes K1, K2 {sampled}; entry points under the other settings "
          f"K1, K2, K3, K4 {settings_train}, their SWA evaluation K1, K3, K4 "
          f"{settings_eval}; Swin-T eval K1, K3, K4, K6, K7, K8 {swin_eval}, Swin-T train "
          f"K1, K2, "
          f"K3 {swin_train}, Swin-T entry points K1, K2, K3, K4, K6 {swin_entry}, their sweep "
          f"K1, K3, K4, K6 {swin_sweep}; the other combinations' eval K1, K3, K4, K7, K8 "
          f"{alt_eval} (the kernels line reports K1/K2 from train, K3/K4/K7/K8 from the CVPPP "
          "eval, K6 from "
          f"the Swin-T eval; K5 {k5}, from phase 8's main_torch.py run)")
    launches = [k1, k2, k3, k4, k5, swin_eval[3], k7, k8]
    gates += [k6_gate, k7_gate, k8_gate]

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
             "pctrans_tpu/ops/msdeform_pallas.py:79"),
            ("K6 window_attention forward (on the Swin-T eval forward's own inputs)",
             "pctrans_torch/csrc/window_attn.cu",
             "none: the JAX package leaves it to XLA (pctrans_tpu/models/swin.py:71-109)"),
            ("K7 packed_mask_stats (library_ms: the f32 bmm of the cast masks; "
             "bf16_library_ms: a bf16 bmm with an f32 output)", "pctrans_torch/csrc/mask_stats.cu",
             "none: the JAX package leaves it to XLA "
             "(pctrans_tpu/inference/device_postprocess.py:62-69)"),
            ("K8 label_pairs (no library call: its twin is torch.bincount)",
             "pctrans_torch/csrc/label_pairs.cu",
             "none: the JAX package scores on the host "
             "(pctrans_tpu/inference/metrics_bbbc.py, metrics_cvppp.py)")]
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
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
