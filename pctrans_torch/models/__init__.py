"""Model stack (mirror of ``pctrans_tpu.models``): the PCTrans meta-architecture
with its registered components (ResNet or Swin backbones; MSDeformAttn, FPN
or FPN + transformer-encoder pixel decoders; the PCTrans or DETR
predictor) and the standalone per-pixel baseline heads.

``build_architecture(cfg)`` is the config-driven entry point of
``pctrans_tpu/models/__init__.py:32``: ``MODEL.ARCHITECTURE == 'MaskFormer'``
builds a :class:`PCTransModel`; the legacy zoo's names are not ported
(ROADMAP slice 6).
"""

from typing import Optional

import torch

from ..config import build_model_config
from .detr_decoder import StandardTransformerDecoder
from .fpn_decoder import BasePixelDecoder, TransformerEncoderPixelDecoder
from .pctrans import PCTransModel
from .per_pixel import PerPixelBaselineHead, PerPixelBaselinePlusHead
from .swin import SwinTransformer

# the JAX package's legacy MODEL_MAP (pctrans_tpu/models/legacy/__init__.py:41-51)
LEGACY_ARCHITECTURES = ("unet_3d", "unet_2d", "fpn_3d", "unet_plus_3d", "unet_plus_2d",
                        "deeplabv3a", "deeplabv3b", "deeplabv3c", "unet_residual_3d")


def build_architecture(cfg, generator: Optional[torch.Generator] = None) -> PCTransModel:
    """The model ``cfg.MODEL.ARCHITECTURE`` names, with seeded random weights."""
    arch = cfg.MODEL.ARCHITECTURE
    if arch == "MaskFormer":
        return PCTransModel(build_model_config(cfg), generator)
    if arch in LEGACY_ARCHITECTURES:
        raise NotImplementedError(f"MODEL.ARCHITECTURE {arch!r}: the legacy zoo is "
                                  "ROADMAP slice 6, not ported yet")
    raise ValueError(f"Unknown MODEL.ARCHITECTURE: {arch}")


__all__ = ["BasePixelDecoder", "PCTransModel", "PerPixelBaselineHead",
           "PerPixelBaselinePlusHead", "StandardTransformerDecoder", "SwinTransformer",
           "TransformerEncoderPixelDecoder", "build_architecture"]
