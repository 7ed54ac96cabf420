"""Model stack (mirror of ``pctrans_tpu.models``): the PCTrans meta-architecture
with its registered components (ResNet or Swin backbones; MSDeformAttn, FPN
or FPN + transformer-encoder pixel decoders; the PCTrans or DETR
predictor) and the standalone per-pixel baseline heads.

``build_architecture(cfg)`` is the config-driven entry point of
``pctrans_tpu/models/__init__.py:32``: ``MODEL.ARCHITECTURE == 'MaskFormer'``
builds a :class:`PCTransModel`; the nine legacy names (the U-Nets,
``fpn_3d``, ``deeplabv3a/b/c``, ``unet_residual_3d``) come from
:mod:`.legacy` with JAX's kwargs.
"""

from typing import Optional

import torch
from torch import nn

from ..config import build_model_config
from .detr_decoder import StandardTransformerDecoder
from .fpn_decoder import BasePixelDecoder, TransformerEncoderPixelDecoder
from .legacy import MODEL_MAP as LEGACY_MODEL_MAP
from .legacy import init_legacy_weights
from .pctrans import PCTransModel
from .per_pixel import PerPixelBaselineHead, PerPixelBaselinePlusHead
from .swin import SwinTransformer


def build_architecture(cfg, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model ``cfg.MODEL.ARCHITECTURE`` names, with seeded random weights
    (``pctrans_tpu/models/__init__.py:32-83``).  Where JAX infers the
    input's channels (DeepLabV3), the port reads ``MODEL.IN_PLANES``; the
    botnet FPN3D sizes its position embeddings from ``MODEL.INPUT_SIZE``."""
    arch = cfg.MODEL.ARCHITECTURE
    if arch == "MaskFormer":
        return PCTransModel(build_model_config(cfg), generator)
    if arch not in LEGACY_MODEL_MAP:
        raise ValueError(f"Unknown MODEL.ARCHITECTURE: {arch}")
    m = cfg.MODEL
    kwargs = dict(in_channel=m.IN_PLANES, out_channel=m.OUT_PLANES,
                  filters=tuple(m.FILTERS), pad_mode=m.PAD_MODE, act_mode=m.ACT_MODE,
                  norm_mode={"sync_bn": "bn"}.get(m.NORM_MODE, m.NORM_MODE))
    if arch in ("unet_3d", "unet_2d", "unet_plus_3d", "unet_plus_2d"):
        kwargs.update(block_type=m.BLOCK_TYPE, is_isotropic=cfg.DATASET.IS_ISOTROPIC,
                      isotropy=tuple(m.ISOTROPY), pooling=m.POOLING_LAYER)
    elif arch == "fpn_3d":
        kwargs.update(backbone_type=m.BACKBONES, block_type=m.BLOCK_TYPE,
                      blocks=tuple(m.BLOCKS), is_isotropic=cfg.DATASET.IS_ISOTROPIC,
                      isotropy=tuple(m.ISOTROPY), deploy=m.DEPLOY_MODE,
                      input_size=tuple(m.INPUT_SIZE))
    elif arch.startswith("deeplab"):
        kwargs.pop("filters")
        kwargs.update(name_variant=arch, aux_out=m.AUX_OUT)
    elif arch == "unet_residual_3d":
        kwargs.update(do_embedding=m.EMBEDDING == 1, head_depth=m.HEAD_DEPTH)
    model = LEGACY_MODEL_MAP[arch](**kwargs)
    init_legacy_weights(model, generator)
    return model

__all__ = ["BasePixelDecoder", "PCTransModel", "PerPixelBaselineHead",
           "PerPixelBaselinePlusHead", "StandardTransformerDecoder", "SwinTransformer",
           "TransformerEncoderPixelDecoder", "build_architecture"]
