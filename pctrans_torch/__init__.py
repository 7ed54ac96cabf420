"""pctrans_torch — PyTorch and CUDA port of PCTrans for NVIDIA Hopper.

The JAX package ``pctrans_tpu`` is the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  config.py   ModelConfig mirror, the CVPPP recipe constant, lazy YAML loading
  weights.py  flax variables (numpy trees) -> this package's modules
  models/     ResNet, MSDeformAttn pixel decoder, position-guided decoder
  ops/        resize, ms-deform attention (K1), mask render (K3),
              upsample+binarize (K4); each op has a plain PyTorch twin and a
              hand-written CUDA kernel built at first use (ops/_build.py)
  engine/     eval step and CVPPP evaluator
  csrc/       CUDA C++ sources of the kernels (sm_90a)

Public functions keep the JAX package's layouts: NHWC images in, the same
output dict keys as ``pctrans_tpu.models.PCTransModel``.  The numpy-only
modules of the JAX package (synthetic data, instance postprocess, CVPPP
metrics, the YAML config tree) are imported, not copied; nothing here
imports jax or flax.
"""
