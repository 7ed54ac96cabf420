"""Model stack (mirror of ``pctrans_tpu.models``): the PCTrans meta-architecture
with its registered components (ResNet or Swin backbones; MSDeformAttn, FPN
or FPN + transformer-encoder pixel decoders; the PCTrans or DETR
predictor) and the standalone per-pixel baseline heads.

``build_architecture(cfg)`` is the config-driven entry point of
``pctrans_tpu/models/__init__.py:32``: ``MODEL.ARCHITECTURE == 'MaskFormer'``
builds a :class:`PCTransModel`; the legacy U-Nets (``unet_3d``, ``unet_2d``,
``unet_plus_3d``, ``unet_plus_2d``) come from :mod:`.legacy` with JAX's
kwargs; the other legacy names are not ported yet (ROADMAP queue A, the
second half of slice 6b).
"""

from typing import Optional

import torch
from torch import nn

from ..config import build_model_config
from .detr_decoder import StandardTransformerDecoder
from .fpn_decoder import BasePixelDecoder, TransformerEncoderPixelDecoder
from .legacy import MODEL_MAP as LEGACY_MODEL_MAP
from .legacy import NOT_PORTED, init_legacy_weights
from .pctrans import PCTransModel
from .per_pixel import PerPixelBaselineHead, PerPixelBaselinePlusHead
from .swin import SwinTransformer

# the JAX package's legacy MODEL_MAP (pctrans_tpu/models/legacy/__init__.py:41-51)
LEGACY_ARCHITECTURES = tuple(LEGACY_MODEL_MAP) + NOT_PORTED


def build_architecture(cfg, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model ``cfg.MODEL.ARCHITECTURE`` names, with seeded random weights
    (``pctrans_tpu/models/__init__.py:32-83``)."""
    arch = cfg.MODEL.ARCHITECTURE
    if arch == "MaskFormer":
        return PCTransModel(build_model_config(cfg), generator)
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"MODEL.ARCHITECTURE {arch!r}: not ported yet (ROADMAP queue A, the "
            "second half of slice 6b: fpn_3d, deeplabv3a/b/c, unet_residual_3d)")
    if arch not in LEGACY_MODEL_MAP:
        raise ValueError(f"Unknown MODEL.ARCHITECTURE: {arch}")
    m = cfg.MODEL
    model = LEGACY_MODEL_MAP[arch](
        in_channel=m.IN_PLANES, out_channel=m.OUT_PLANES, filters=tuple(m.FILTERS),
        pad_mode=m.PAD_MODE, act_mode=m.ACT_MODE,
        norm_mode={"sync_bn": "bn"}.get(m.NORM_MODE, m.NORM_MODE),
        block_type=m.BLOCK_TYPE, is_isotropic=cfg.DATASET.IS_ISOTROPIC,
        isotropy=tuple(m.ISOTROPY), pooling=m.POOLING_LAYER)
    init_legacy_weights(model, generator)
    return model


__all__ = ["BasePixelDecoder", "PCTransModel", "PerPixelBaselineHead",
           "PerPixelBaselinePlusHead", "StandardTransformerDecoder", "SwinTransformer",
           "TransformerEncoderPixelDecoder", "build_architecture"]
