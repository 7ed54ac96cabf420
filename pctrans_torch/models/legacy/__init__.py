"""Legacy pytorch_connectomics model zoo (mirror of
``pctrans_tpu/models/legacy``), channel-first: 2D models take
[B, C, H, W], 3D models [B, C, D, H, W].

Ported: the block zoo (:mod:`.blocks`) and the residual U-Nets
(:mod:`.unet`).  ``MODEL_MAP`` holds the names ``build_architecture``
dispatches; the other five names of the JAX ``MODEL_MAP`` (``fpn_3d``,
``deeplabv3a/b/c``, ``unet_residual_3d``) are ``NOT_PORTED`` (ROADMAP queue
A, the second half of slice 6b).
"""

from typing import Optional

import torch
from torch import nn

from .blocks import (BasicBlock, BasicBlockPA, BasicBlockSE, ConvNormAct,
                     NonLocalBlock, SELayer, get_legacy_activation, get_legacy_norm,
                     linear_resize)
from .unet import UNet, UNet2D, UNet3D, UNetPlus2D, UNetPlus3D

MODEL_MAP = {
    "unet_3d": UNet3D,
    "unet_2d": UNet2D,
    "unet_plus_3d": UNetPlus3D,
    "unet_plus_2d": UNetPlus2D,
}
NOT_PORTED = ("fpn_3d", "deeplabv3a", "deeplabv3b", "deeplabv3c", "unet_residual_3d")


def init_legacy_weights(model: nn.Module,
                        generator: Optional[torch.Generator] = None) -> None:
    """flax's default initializers: LeCun normal (a normal truncated at two
    deviations, fan-in scaled) for conv and dense kernels, zero biases,
    identity norms."""
    from ..pctrans import variance_scaling_

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                variance_scaling_(m.weight, 1.0, "fan_in", generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)


__all__ = ["BasicBlock", "BasicBlockPA", "BasicBlockSE", "ConvNormAct", "MODEL_MAP",
           "NOT_PORTED", "NonLocalBlock", "SELayer", "UNet", "UNet2D", "UNet3D",
           "UNetPlus2D", "UNetPlus3D", "get_legacy_activation", "get_legacy_norm",
           "init_legacy_weights", "linear_resize"]
