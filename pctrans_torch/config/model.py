"""Model configuration (mirror of ``pctrans_tpu/models/pctrans.py:23-137``).

``ModelConfig`` carries the fields this port reads.  The JAX config's
``remat``/``remat_policy`` train-memory knobs are not carried: remat is a
training-only choice of the JAX graph.

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
    # Swin (MODEL.BACKBONE.NAME D2SwinTransformer), Swin-T unless an optional
    # MODEL.SWIN node (Mask2Former's, read by swin_fields) sizes it
    swin_embed_dim: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window_size: int = 7
    swin_drop_path: float = 0.3
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


BACKBONES = ("build_resnet_backbone", "D2SwinTransformer")
PIXEL_DECODERS = ("MSDeformAttnPixelDecoder", "BasePixelDecoder",
                  "TransformerEncoderPixelDecoder")
TRANSFORMER_DECODERS = ("MultiScaleMaskedTransformerDecoder",
                        "StandardTransformerDecoder")


def validate(c: ModelConfig) -> None:
    """Raise ``ValueError`` for a component or combination the model cannot
    build (``pctrans_tpu/models/pctrans.py:171-263`` dispatches on the same
    names)."""
    for value, known, key in (
            (c.backbone_name, BACKBONES, "MODEL.BACKBONE.NAME"),
            (c.pixel_decoder_name, PIXEL_DECODERS, "MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME"),
            (c.transformer_decoder_name, TRANSFORMER_DECODERS,
             "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME")):
        if value not in known:
            raise ValueError(f"{key} {value!r}: one of {known}")
    if c.sem_seg_head_name != "MaskFormerHead":
        raise ValueError(
            f"MODEL.SEM_SEG_HEAD.NAME={c.sem_seg_head_name!r}: only "
            "MaskFormerHead composes into PCTransModel; the per-pixel "
            "baselines (models/per_pixel.py) are standalone heads")
    if (c.transformer_decoder_name == "StandardTransformerDecoder"
            and c.pixel_decoder_name == "BasePixelDecoder"):
        # JAX fails here on the missing encoder features (enc_top is None)
        raise ValueError("StandardTransformerDecoder attends over the pixel "
                         "decoder's encoder features; BasePixelDecoder has none")
    if c.backbone_name == "build_resnet_backbone" and c.backbone_depth not in (14, 50, 101):
        raise ValueError(f"unsupported ResNet depth {c.backbone_depth}")


# Mask2Former's MODEL.SWIN keys (``add_maskformer2_config``) that the port's
# Swin computes at one value only, and that value
SWIN_FIXED = {"APE": False, "PATCH_NORM": True, "PATCH_SIZE": 4, "MLP_RATIO": 4.0,
              "QKV_BIAS": True, "QK_SCALE": None, "DROP_RATE": 0.0, "ATTN_DROP_RATE": 0.0,
              "USE_CHECKPOINT": False, "OUT_FEATURES": ("res2", "res3", "res4", "res5")}
# the keys that size it, and the pretraining size (read only by APE)
SWIN_SIZES = ("EMBED_DIM", "DEPTHS", "NUM_HEADS", "WINDOW_SIZE", "DROP_PATH_RATE")
SWIN_UNUSED = ("PRETRAIN_IMG_SIZE",)


def swin_fields(sw) -> dict:
    """The ModelConfig fields of a ``MODEL.SWIN`` node as Mask2Former
    publishes it.  Raises ``ValueError``, naming the key, for a key the port
    does not know or a value it cannot honour: an absolute position
    embedding, no patch norm, other patch sizes or MLP ratios, no qkv bias,
    a set qk scale, dropout, activation checkpointing, other outputs."""
    unknown = sorted(set(sw) - set(SWIN_FIXED) - set(SWIN_SIZES) - set(SWIN_UNUSED))
    if unknown:
        raise ValueError(f"MODEL.SWIN.{unknown[0]}: not a key of Mask2Former's Swin node")
    for key, honoured in SWIN_FIXED.items():
        value = sw.get(key, honoured)
        if isinstance(honoured, tuple):
            same = isinstance(value, (list, tuple)) and tuple(value) == honoured
        elif honoured is None or isinstance(honoured, bool):
            same = value is honoured
        else:
            same = not isinstance(value, bool) and value == honoured
        if not same:
            raise ValueError(f"MODEL.SWIN.{key}={value!r}: the port's Swin computes "
                             f"{key} {honoured!r} only")
    return dict(swin_embed_dim=sw.EMBED_DIM, swin_depths=tuple(sw.DEPTHS),
                swin_num_heads=tuple(sw.NUM_HEADS), swin_window_size=sw.WINDOW_SIZE,
                swin_drop_path=sw.DROP_PATH_RATE)


def build_model_config(cfg) -> ModelConfig:
    """ModelConfig from a YACS-style config tree (same field mapping as
    ``pctrans_tpu.models.pctrans.build_model_config``)."""
    mf = cfg.MODEL.MASK_FORMER
    sh = cfg.MODEL.SEM_SEG_HEAD
    sw = cfg.MODEL.get("SWIN", None)
    swin_kwargs = {} if sw is None else swin_fields(sw)
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
        **swin_kwargs,
    )

