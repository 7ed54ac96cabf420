"""pctrans_torch — PyTorch and CUDA port of PCTrans for NVIDIA Hopper.

The JAX package ``pctrans_tpu`` is the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  config/     the YACS-style config tree with its own YAML-subset reader,
              ModelConfig and the CVPPP recipe constant
  weights.py  flax variables (numpy trees) -> this package's modules
  models/     ResNet (+ the detectron2 R-50 pickle reader), MSDeformAttn
              pixel decoder, masked transformer decoder with
              position queries
  ops/        resize, point sampling, host LAP, and the kernel-backed ops:
              ms-deform attention forward (K1, and K5 its separable form)
              and backward (K2), mask render (K3), upsample+binarize (K4);
              each has a plain PyTorch twin and a hand-written CUDA kernel
              built at first use (ops/_build.py)
  losses/     dense SetCriterion: matcher, re-id, discriminative, focal
  engine/     train step and solver, eval step and the evaluator with its
              label pipeline, checkpoints, the Trainer behind
              scripts/main_torch.py and scripts/eval_torch.py
  parallel/   one process per card: the process group, SyncBN's and the
              criterion's collectives, per-rank draws, gradient averaging
  data/       padded targets, CVPPP, BBBC, cellpose, MoNuSeg and synthetic
              datasets, the prefetching loader with per-rank shares, TTA
  inference/  instance postprocess (device and numpy), the submission's
              cleanup, CVPPP and BBBC metrics
  utils/      the training monitor (metrics.jsonl, the profiler window)
              and the validation panels
  csrc/       CUDA C++ sources of the kernels (sm_90a)

Public functions keep the JAX package's layouts: NHWC images in, the same
output dict keys as ``pctrans_tpu.models.PCTransModel``.  The JAX-free host
modules (config, datasets and loader, instance postprocess, CVPPP metrics)
are copies of the JAX package's, tested equal; nothing here imports jax,
flax, PyYAML or ``pctrans_tpu``.
"""
