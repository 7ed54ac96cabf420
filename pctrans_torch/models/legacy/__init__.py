"""Legacy pytorch_connectomics model zoo (mirror of
``pctrans_tpu/models/legacy``), channel-first: 2D models take
[B, C, H, W], 3D models [B, C, D, H, W].

The block zoo (:mod:`.blocks`), the residual U-Nets (:mod:`.unet`), FPN3D
over its four backbones (:mod:`.fpn3d`: ResNet3D, RepVGG3D with
:func:`repvgg_convert`, BotNet3D, EfficientNet3D), DeepLabV3 a/b/c over
ResNet2D (:mod:`.deeplab`), ``unet_residual_3d`` (:mod:`.resunet`) and the
PatchGAN :class:`Discriminator3D`.  ``MODEL_MAP`` holds the nine names of
the JAX ``MODEL_MAP`` that ``build_architecture`` dispatches.
"""

from typing import Optional

import torch
from torch import nn

from .blocks import (BasicBlock, BasicBlockPA, BasicBlockSE, ConvNormAct,
                     NonLocalBlock, SELayer, get_legacy_activation, get_legacy_norm,
                     linear_resize)
from .botnet import BotAttention, BotNet3D
from .deeplab import DeepLabV3
from .discriminator import Discriminator3D
from .efficientnet import EfficientNet3D
from .fpn3d import FPN3D
from .repvgg import RepVGG3D, RepVGGBlock3D, repvgg_convert
from .resnet_legacy import ResNet2D, ResNet3D
from .resunet import UNetResidual3D
from .unet import UNet, UNet2D, UNet3D, UNetPlus2D, UNetPlus3D

MODEL_MAP = {
    "unet_3d": UNet3D,
    "unet_2d": UNet2D,
    "fpn_3d": FPN3D,
    "unet_plus_3d": UNetPlus3D,
    "unet_plus_2d": UNetPlus2D,
    "deeplabv3a": DeepLabV3,
    "deeplabv3b": DeepLabV3,
    "deeplabv3c": DeepLabV3,
    "unet_residual_3d": UNetResidual3D,
}


def init_legacy_weights(model: nn.Module,
                        generator: Optional[torch.Generator] = None) -> None:
    """flax's default initializers: LeCun normal (a normal truncated at two
    deviations, fan-in scaled) for conv and dense kernels, zero biases,
    identity norms; BotNet's position embeddings normal(dim_head ** -0.5)."""
    from ..pctrans import variance_scaling_

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                variance_scaling_(m.weight, 1.0, "fan_in", generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BotAttention):
                for p in (m.pos_emb_h, m.pos_emb_w):
                    p.normal_(0.0, m.dim_head ** -0.5, generator=generator)


__all__ = ["BasicBlock", "BasicBlockPA", "BasicBlockSE", "BotNet3D", "ConvNormAct",
           "DeepLabV3", "Discriminator3D", "EfficientNet3D", "FPN3D", "MODEL_MAP",
           "NonLocalBlock", "RepVGG3D", "RepVGGBlock3D", "ResNet2D", "ResNet3D",
           "SELayer", "UNet", "UNet2D", "UNet3D", "UNetPlus2D", "UNetPlus3D",
           "UNetResidual3D", "get_legacy_activation", "get_legacy_norm",
           "init_legacy_weights", "linear_resize", "repvgg_convert"]
