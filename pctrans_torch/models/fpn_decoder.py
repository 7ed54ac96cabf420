"""Alternative pixel decoders (mirror of ``pctrans_tpu/models/fpn_decoder.py``):
the plain FPN ``BasePixelDecoder`` and ``TransformerEncoderPixelDecoder``,
an FPN whose lowest-resolution level first goes through DETR encoder
layers.

Both take the backbone's NCHW maps and return the triple of
``MSDeformAttnPixelDecoder``: ``(mask_features [B, mask_dim, H/4, W/4],
encoder features [B, conv_dim, H/32, W/32] or None, [res5', res4', res3'])``.
The FPN sum upsamples by nearest neighbour with torch's floor rule
(``fpn_decoder.py:27-32``).  Module names follow the flax tree
(``layer_4``, ``adapter_3``, ``mask_features``, ...), so the weight bridge
maps them one to one.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_nearest_torch
from .layers import ConvNorm, position_embedding_sine
from .transformer_decoder import attention


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(qkv_features=d, out_features=d)``:
    ``query``, ``key``, ``value`` and ``out`` projections around
    scaled-dot-product attention.  Logits and softmax run in f32 (flax runs
    the softmax in the compute dtype; the two differ in bf16 only)."""

    def __init__(self, d_model: int, nheads: int):
        super().__init__()
        self.nheads = nheads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.out(attention(self.query(q), self.key(k), self.value(v), self.nheads))


class TransformerEncoderLayerPostNorm(nn.Module):
    """One DETR encoder layer, post-norm: q = k = src + pos
    (``fpn_decoder.py:37-63``)."""

    def __init__(self, d_model: int, nheads: int, d_ffn: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nheads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class BasePixelDecoder(nn.Module):
    """Plain FPN (``fpn_decoder.py:66-117``): top-down over res5..res2, a
    3x3 output conv on the lowest-resolution level, a 1x1 lateral plus the
    nearest-upsampled running map then a 3x3 conv on each other level; the
    first three maps are the multi-scale features, the last feeds the 3x3
    ``mask_features`` conv."""

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 128,
                 mask_dim: int = 16, norm: str = "SyncBN",
                 in_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.in_features = list(in_features)[::-1]      # res5 first
        n = len(self.in_features)
        for idx, name in enumerate(self.in_features):
            if idx == 0:
                self.add_module(f"layer_{n}", ConvNorm(in_channels[name], conv_dim, 3,
                                                       norm=norm, relu=True))
            else:
                self.add_module(f"adapter_{n - idx}",
                                ConvNorm(in_channels[name], conv_dim, 1, norm=norm))
                self.add_module(f"layer_{n - idx}",
                                ConvNorm(conv_dim, conv_dim, 3, norm=norm, relu=True))
        self.mask_features = ConvNorm(conv_dim, mask_dim, 3)

    def _top_forward(self, x: torch.Tensor):
        """The lowest-resolution level's map and the encoder features."""
        return getattr(self, f"layer_{len(self.in_features)}")(x), None

    def forward(self, features: Dict[str, torch.Tensor]):
        n = len(self.in_features)
        multi_scale = []
        encoder_features = None
        for idx, name in enumerate(self.in_features):
            x = features[name]
            if idx == 0:
                y, encoder_features = self._top_forward(x)
            else:
                lat = getattr(self, f"adapter_{n - idx}")(x)
                y = lat + resize_nearest_torch(y, lat.shape[-2:]).to(lat.dtype)
                y = getattr(self, f"layer_{n - idx}")(y)
            if len(multi_scale) < 3:         # maskformer_num_feature_levels
                multi_scale.append(y)
        return self.mask_features(y), encoder_features, multi_scale


class TransformerEncoderPixelDecoder(BasePixelDecoder):
    """The FPN with ``transformer_enc_layers`` DETR encoder layers (sine
    position embeddings) on a 1x1 projection of the lowest-resolution level,
    whose output is also returned as the encoder features
    (``fpn_decoder.py:120-186``)."""

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 128,
                 mask_dim: int = 16, norm: str = "SyncBN", nheads: int = 8,
                 d_ffn: int = 1024, transformer_enc_layers: int = 6,
                 in_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        top = in_features[-1]
        # the top level's 3x3 conv reads the encoder output
        super().__init__({**in_channels, top: conv_dim}, conv_dim, mask_dim, norm,
                         in_features)
        self.conv_dim = conv_dim
        self.input_proj = nn.Conv2d(in_channels[top], conv_dim, 1)
        self.encoder_layer = nn.ModuleList(
            TransformerEncoderLayerPostNorm(conv_dim, nheads, d_ffn)
            for _ in range(transformer_enc_layers))

    def _top_forward(self, x: torch.Tensor):
        B, _, H, W = x.shape
        C = self.conv_dim
        t = self.input_proj(x).flatten(2).transpose(1, 2)
        pos = position_embedding_sine(H, W, C // 2, x.device).reshape(1, H * W, C)
        pos = pos.to(t.dtype)
        for layer in self.encoder_layer:
            t = layer(t, pos)
        encoder_features = t.transpose(1, 2).reshape(B, C, H, W)
        top = getattr(self, f"layer_{len(self.in_features)}")
        return top(encoder_features), encoder_features


def build_fpn_decoder(name: str, in_channels: Dict[str, int], conv_dim: int,
                      mask_dim: int, norm: str, nheads: int, d_ffn: int,
                      enc_layers: int) -> nn.Module:
    """The FPN pixel decoder of that name (``per_pixel.py:32-43``)."""
    if name == "BasePixelDecoder":
        return BasePixelDecoder(in_channels, conv_dim, mask_dim, norm)
    if name == "TransformerEncoderPixelDecoder":
        return TransformerEncoderPixelDecoder(in_channels, conv_dim, mask_dim, norm,
                                              nheads, d_ffn, enc_layers)
    raise ValueError(f"Unknown FPN pixel decoder: {name}")
