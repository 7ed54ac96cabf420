"""The model sizes the reference reads (the fields of the port's
``ModelConfig`` on the recipe's path), filled from a configuration file
under ``portbench/configs``."""

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
    head_norm: str = "SyncBN"
    stride_in_1x1: bool = False
    enc_points: int = 4
    fpn_legacy_swap: bool = False
    pixel_mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    upsample2x: bool = False
    dtype: str = "float32"         # "bfloat16" = autocast mixed precision

    @classmethod
    def from_sizes(cls, sizes: dict) -> "ModelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(sizes) - fields
        if unknown:
            raise ValueError(f"unknown model sizes {sorted(unknown)}")
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in sizes.items()})
