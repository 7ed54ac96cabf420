"""pctrans_torch — PyTorch and CUDA port of PCTrans for NVIDIA Hopper.

The JAX package ``pctrans_tpu`` is the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  config.py   ModelConfig mirror and the CVPPP recipe constant
  weights.py  flax variables (numpy trees) -> this package's modules
  models/     ResNet, MSDeformAttn pixel decoder, position-guided decoder
  ops/        resize, point sampling, host LAP, and the kernel-backed ops:
              ms-deform attention forward (K1) and backward (K2), mask
              render (K3), upsample+binarize (K4); each has a plain PyTorch
              twin and a hand-written CUDA kernel built at first use
              (ops/_build.py)
  losses/     dense SetCriterion: matcher, re-id, discriminative, focal
  engine/     train step and solver, eval step and CVPPP evaluator
  data/       padded targets, synthetic scenes
  inference/  CVPPP instance postprocess and metrics (numpy)
  csrc/       CUDA C++ sources of the kernels (sm_90a)

Public functions keep the JAX package's layouts: NHWC images in, the same
output dict keys as ``pctrans_tpu.models.PCTransModel``.  The numpy host
modules (synthetic scenes, instance postprocess, CVPPP metrics) are copies
of the JAX package's, tested bit-equal; nothing here imports jax, flax or
``pctrans_tpu``.
"""
