"""Per-pixel semantic baseline heads (mirror of ``pctrans_tpu/models/per_pixel.py``),
registered under ``MODEL.SEM_SEG_HEAD.NAME`` but standalone: they do not
compose into ``PCTransModel``, as in the JAX package.

* ``PerPixelBaselineHead``: an FPN pixel decoder and a 1x1 predictor conv
  -> class logits [B, num_classes, H/4, W/4] f32.
* ``PerPixelBaselinePlusHead``: an FPN pixel decoder and a DETR predictor
  (one query per class, no classification) over the encoder features ->
  ``{"pred_masks", "aux_masks"}``.

Both take the backbone's NCHW maps; the caller upsamples and scores.
``init_head`` gives the JAX initializers' distributions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .detr_decoder import StandardTransformerDecoder
from .fpn_decoder import build_fpn_decoder
from .pctrans import init_weights, variance_scaling_


class PerPixelBaselineHead(nn.Module):
    """``per_pixel.py:46-71``."""

    def __init__(self, in_channels: Dict[str, int], num_classes: int = 1,
                 conv_dim: int = 128, mask_dim: int = 16, norm: str = "SyncBN",
                 pixel_decoder_name: str = "BasePixelDecoder", nheads: int = 8,
                 d_ffn: int = 1024, enc_layers: int = 6):
        super().__init__()
        self.pixel_decoder = build_fpn_decoder(pixel_decoder_name, in_channels, conv_dim,
                                               mask_dim, norm, nheads, d_ffn, enc_layers)
        self.predictor = nn.Conv2d(mask_dim, num_classes, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        mask_features, _, _ = self.pixel_decoder(features)
        return self.predictor(mask_features).float()


class PerPixelBaselinePlusHead(nn.Module):
    """``per_pixel.py:74-127``: the DETR predictor reads the encoder
    features (``transformer_in_feature="transformer_encoder"``, which needs
    the TransformerEncoderPixelDecoder) or a backbone map by name."""

    def __init__(self, in_channels: Dict[str, int], num_classes: int = 1,
                 conv_dim: int = 128, mask_dim: int = 16, norm: str = "SyncBN",
                 pixel_decoder_name: str = "TransformerEncoderPixelDecoder",
                 transformer_in_feature: str = "transformer_encoder",
                 hidden_dim: int = 128, nheads: int = 8, d_ffn: int = 1024,
                 enc_layers: int = 6, dec_layers: int = 10,
                 deep_supervision: bool = True):
        super().__init__()
        if transformer_in_feature == "transformer_encoder":
            if pixel_decoder_name != "TransformerEncoderPixelDecoder":
                raise ValueError("transformer_in_feature='transformer_encoder' requires "
                                 "the TransformerEncoderPixelDecoder")
            predictor_in = conv_dim
        else:
            predictor_in = in_channels[transformer_in_feature]
        self.transformer_in_feature = transformer_in_feature
        self.pixel_decoder = build_fpn_decoder(pixel_decoder_name, in_channels, conv_dim,
                                               mask_dim, norm, nheads, d_ffn, enc_layers)
        self.predictor = StandardTransformerDecoder(
            predictor_in, hidden_dim=hidden_dim, num_queries=num_classes, nheads=nheads,
            dim_feedforward=d_ffn, enc_layers=0, dec_layers=dec_layers,
            mask_dim=mask_dim, mask_classification=False,
            deep_supervision=deep_supervision)

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict:
        mask_features, encoder_features, _ = self.pixel_decoder(features)
        x = (encoder_features if self.transformer_in_feature == "transformer_encoder"
             else features[self.transformer_in_feature])
        return self.predictor(x, mask_features)


def init_head(head: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX initializers' distributions: Xavier-uniform for the decoders'
    layers, N(0, 1) for the query embedding, zero biases, and for the
    baseline's predictor ``_MSRA`` (``per_pixel.py:29``: truncated normal,
    fan-out, scale 2)."""
    init_weights(head, generator)
    if isinstance(head, PerPixelBaselineHead):
        with torch.no_grad():
            variance_scaling_(head.predictor.weight, 2.0, "fan_out", generator)
