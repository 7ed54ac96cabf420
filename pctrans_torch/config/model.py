"""Model configuration (mirror of ``pctrans_tpu/models/pctrans.py:23-137``).

``ModelConfig`` carries the fields this port reads.  The JAX config's
Swin fields and its ``remat``/``remat_policy`` train-memory knobs are not
carried: the Swin backbone is not ported yet, and remat is a training-only
choice of the JAX graph.

``CVPPP_RECIPE`` and ``BBBC_RECIPE`` are the configurations that
``configs/{CVPPP,BBBC}/*-PCTrans{-Base,}.yaml`` build, as plain constants.
``build_model_config`` maps a config tree loaded by
``pctrans_torch.config.load_cfg``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    hidden_dim: int = 128
    conv_dim: int = 128
    mask_dim: int = 16
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 1024
    enc_layers: int = 6
    dec_layers: int = 9            # cfg DEC_LAYERS - 1
    points_num: int = 1
    sem_loss_on: bool = True
    rel_coord: bool = True
    backbone_depth: int = 50
    backbone_norm: str = "FrozenBN"
    head_norm: str = "SyncBN"      # FPN + seg-head norm
    stride_in_1x1: bool = False
    enc_points: int = 4
    backbone_name: str = "build_resnet_backbone"
    pixel_decoder_name: str = "MSDeformAttnPixelDecoder"
    fpn_legacy_swap: bool = False
    sem_seg_head_name: str = "MaskFormerHead"
    transformer_decoder_name: str = "MultiScaleMaskedTransformerDecoder"
    pixel_mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    upsample2x: bool = False
    dtype: str = "float32"         # "bfloat16" = autocast mixed precision


# configs/CVPPP/CVPPP-PCTrans{-Base,}.yaml on top of config/defaults.py:
# everything at the ModelConfig defaults except the pixel std (255, a
# published quirk applied on top of the loaders' own normalization) and
# MIXED_PRECESION: true.
CVPPP_RECIPE = ModelConfig(pixel_std=(255.0, 255.0, 255.0), dtype="bfloat16")
# configs/BBBC/BBBC-PCTrans{-Base,}.yaml: the CVPPP recipe with 300 queries
BBBC_RECIPE = dataclasses.replace(CVPPP_RECIPE, num_queries=300)


def validate(c: ModelConfig) -> None:
    """Raise for components this port does not have yet."""
    if c.backbone_name != "build_resnet_backbone":
        raise NotImplementedError(
            f"backbone {c.backbone_name!r}: ported in ROADMAP item 24 "
            "(alternative components)")
    if c.pixel_decoder_name != "MSDeformAttnPixelDecoder":
        raise NotImplementedError(
            f"pixel decoder {c.pixel_decoder_name!r}: ported in ROADMAP "
            "item 24 (alternative components)")
    if c.transformer_decoder_name != "MultiScaleMaskedTransformerDecoder":
        raise NotImplementedError(
            f"transformer decoder {c.transformer_decoder_name!r}: ported in "
            "ROADMAP item 24 (alternative components)")
    if c.sem_seg_head_name != "MaskFormerHead":
        raise ValueError(
            f"MODEL.SEM_SEG_HEAD.NAME={c.sem_seg_head_name!r}: only "
            "MaskFormerHead composes into PCTransModel")
    if c.fpn_legacy_swap:
        raise NotImplementedError(
            "fpn_legacy_swap=True (the published stride-8 FPN quirk): "
            "ported in ROADMAP item 24a")
    if c.backbone_depth not in (14, 50, 101):
        raise ValueError(f"unsupported ResNet depth {c.backbone_depth}")


def build_model_config(cfg) -> ModelConfig:
    """ModelConfig from a YACS-style config tree (same field mapping as
    ``pctrans_tpu.models.pctrans.build_model_config``)."""
    mf = cfg.MODEL.MASK_FORMER
    sh = cfg.MODEL.SEM_SEG_HEAD
    return ModelConfig(
        hidden_dim=mf.HIDDEN_DIM,
        conv_dim=sh.CONVS_DIM,
        mask_dim=sh.MASK_DIM,
        num_queries=mf.NUM_OBJECT_QUERIES,
        nheads=mf.NHEADS,
        dim_feedforward=mf.DIM_FEEDFORWARD,
        enc_layers=sh.TRANSFORMER_ENC_LAYERS,
        dec_layers=mf.DEC_LAYERS - 1,
        points_num=mf.POSITION_POINTS_NUM,
        sem_loss_on=mf.SEMANTIC_LOSS_ON,
        rel_coord=mf.REL_COORD,
        backbone_depth=cfg.MODEL.RESNETS.DEPTH,
        backbone_norm=cfg.MODEL.RESNETS.NORM,
        head_norm=sh.NORM,
        stride_in_1x1=cfg.MODEL.RESNETS.STRIDE_IN_1X1,
        backbone_name=cfg.MODEL.BACKBONE.NAME,
        pixel_decoder_name=sh.PIXEL_DECODER_NAME,
        sem_seg_head_name=sh.get("NAME", "MaskFormerHead"),
        transformer_decoder_name=mf.get(
            "TRANSFORMER_DECODER_NAME", "MultiScaleMaskedTransformerDecoder"),
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        dtype="bfloat16" if cfg.MODEL.MIXED_PRECESION else "float32",
        upsample2x=cfg.MODEL.MASK_FORMER.TPU_RECIPE.UPSAMPLE2X,
        fpn_legacy_swap=bool(sh.get("FPN_LEGACY_SWAP", False)),
    )

