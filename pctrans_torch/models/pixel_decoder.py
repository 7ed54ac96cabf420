"""MSDeformAttn pixel decoder (mirror of ``pctrans_tpu/models/pixel_decoder.py``).

Projects res3-5 to ``conv_dim`` channels, runs the deformable-attention
encoder over the concatenated flattened levels (low resolution first: res5,
res4, res3), splits the result back into maps and fuses res2 through one
FPN stage into the stride-4 mask features.  ``fpn_legacy_swap`` gives the
published model's operands instead (``pixel_decoder.py:172-182``): the res2
lateral resized down onto res3's grid and added there, so the mask features
sit on the stride-8 grid.  Maps are NCHW.

Dtypes are JAX's under the bf16 recipe on either device: ``input_gn`` and
the encoder's LayerNorms give the compute dtype (their statistics f32); the
FPN's adapter and layer are ``ConvNorm`` with GN or SyncBN, which give f32,
so the mask features are f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msdeform import ms_deform_attn
from ..ops.resize import resize_bilinear
from .layers import ConvNorm, GroupNorm, LayerNorm, in_f32, position_embedding_sine


def sampling_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional bias init (``pixel_decoder.py:30-43``): head h points along
    angle 2*pi*h/n_heads, scaled by the point index."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    grid = grid * np.arange(1, n_points + 1, dtype=np.float32)[None, None, :, None]
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (``pixel_decoder.py:46-106``).

    Sampling offsets and attention weights are computed in f32 with autocast
    off: bf16's 8-bit mantissa would quantise pixel coordinates.
    """

    def __init__(self, d_model: int = 128, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, input_flatten,
                spatial_shapes: Sequence[Tuple[int, int]],
                impl: Optional[str] = None) -> torch.Tensor:
        B, Lq, C = query.shape
        S = input_flatten.shape[1]
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten).reshape(B, S, M, C // M)

        def sampling(q, ref):
            offsets = self.sampling_offsets(q).reshape(B, Lq, M, L, P, 2)
            attn = self.attention_weights(q).reshape(B, Lq, M, L * P)
            attn = attn.softmax(-1).reshape(B, Lq, M, L, P)
            normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                      dtype=torch.float32, device=q.device)
            return (ref[:, :, None, :, None, :]
                    + offsets / normalizer[None, None, None, :, None, :]), attn

        locations, attn = in_f32(sampling, query, reference_points)
        out = ms_deform_attn(value, spatial_shapes, locations, attn, impl=impl)
        return self.output_proj(out)


class MSDeformAttnEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = LayerNorm(d_model, keep_dtype=True)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, keep_dtype=True)

    def forward(self, src, pos, reference_points, spatial_shapes, impl=None):
        attn = self.self_attn(src + pos, reference_points, src, spatial_shapes,
                              impl=impl)
        src = self.norm1(src + attn)
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + y)


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             device=None) -> torch.Tensor:
    """Normalised pixel-centre grid per level, replicated across levels
    (``pixel_decoder.py:134-145``): [S, L, 2] as (x, y)."""
    refs = []
    for (H, W) in spatial_shapes:
        ry = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
        rx = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(refs, 0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


class MSDeformAttnPixelDecoder(nn.Module):
    """Backbone features -> (mask_features [B, conv_dim, H/4, W/4] (H/8 x
    W/8 under ``fpn_legacy_swap``), the encoder's res5 map, multi-scale maps
    [res5', res4', res3'])."""

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 128,
                 norm: str = "SyncBN", transformer_layers: int = 6,
                 n_heads: int = 8, n_points: int = 4, d_ffn: int = 1024,
                 transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 fpn_in_features: Sequence[str] = ("res2",),
                 fpn_legacy_swap: bool = False):
        super().__init__()
        self.fpn_legacy_swap = fpn_legacy_swap
        self.tif = list(transformer_in_features)[::-1]     # res5, res4, res3
        self.fpn = list(fpn_in_features)[::-1]
        self.conv_dim = conv_dim
        L = len(self.tif)
        self.input_proj = nn.ModuleList(
            nn.Conv2d(in_channels[n], conv_dim, 1) for n in self.tif)
        self.input_gn = nn.ModuleList(
            GroupNorm(32, conv_dim, keep_dtype=True) for _ in self.tif)
        self.level_embed = nn.Parameter(torch.empty(L, conv_dim))
        self.encoder_layer = nn.ModuleList(
            MSDeformAttnEncoderLayer(conv_dim, d_ffn, L, n_heads, n_points)
            for _ in range(transformer_layers))
        self.adapter = nn.ModuleList(
            ConvNorm(in_channels[n], conv_dim, 1, norm=norm) for n in self.fpn)
        self.layer = nn.ModuleList(
            ConvNorm(conv_dim, conv_dim, 3, norm=norm, relu=True)
            for _ in self.fpn)

    def forward(self, features: Dict[str, torch.Tensor], impl=None):
        srcs, pos, spatial_shapes = [], [], []
        for i, name in enumerate(self.tif):
            x = features[name]
            B, _, H, W = x.shape
            y = self.input_gn[i](self.input_proj[i](x))
            srcs.append(y.flatten(2).transpose(1, 2))
            pe = position_embedding_sine(H, W, self.conv_dim // 2, x.device)
            pos.append(pe.reshape(H * W, self.conv_dim).to(y.dtype)
                       + self.level_embed[i].to(y.dtype))
            spatial_shapes.append((H, W))
        src = torch.cat(srcs, 1)
        pos_flat = torch.cat(pos, 0)[None].expand(src.shape[0], -1, -1)
        refs = encoder_reference_points(spatial_shapes, src.device)
        refs = refs[None].expand(src.shape[0], -1, -1, -1)
        y = src
        for layer in self.encoder_layer:
            y = layer(y, pos_flat, refs, spatial_shapes, impl=impl)

        out: List[torch.Tensor] = []
        start = 0
        for (H, W) in spatial_shapes:
            out.append(y[:, start:start + H * W].transpose(1, 2)
                       .reshape(y.shape[0], self.conv_dim, H, W))
            start += H * W
        # FPN: stride-4 mask features = lateral(res2) + upsampled res3', or
        # under the legacy swap res3' + lateral(res2) downsampled (stride 8)
        for i, name in enumerate(self.fpn):
            x = features[name]
            lateral = self.adapter[i](x)
            if self.fpn_legacy_swap:
                fused = out[-1] + resize_bilinear(lateral, out[-1].shape[-2:])
            else:
                fused = lateral + resize_bilinear(out[-1], x.shape[-2:])
            out.append(self.layer[i](fused))
        return out[-1], out[0], out[:3]
