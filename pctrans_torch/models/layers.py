"""Shared layers (mirror of ``pctrans_tpu/models/layers.py``).

Convolution modules take NCHW tensors (PyTorch's layout); the sine
embeddings return the JAX layouts ([H, W, C] and [..., 2*dim*points]).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine (``layers.py:38-61``).

    Folds in f32 and applies in the activation dtype, so a bf16 backbone
    stays bf16.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.scale * torch.rsqrt(self.var + self.eps)
        b = self.bias - self.mean * w
        return x * w.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` (``layers.py:73-79``).

    Train mode normalises with the batch statistics and updates the running
    ones with momentum 0.1 from the *biased* batch variance, as flax does
    (``nn.BatchNorm2d`` would use the unbiased one).  Eval mode uses the
    running statistics.  SyncBN on one card is this module.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean * m)
            self.running_var.mul_(1.0 - m).add_(var * m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def get_norm(name: str, features: int) -> Optional[nn.Module]:
    """detectron2 ``get_norm`` mirror (``layers.py:64-86``): BN and SyncBN
    are :class:`BatchNorm` (eps 1e-5), GN has 32 groups."""
    if not name:
        return None
    if name in ("BN", "SyncBN"):
        return BatchNorm(features)
    if name == "GN":
        return nn.GroupNorm(32, features, eps=1e-5)
    if name == "FrozenBN":
        return FrozenBatchNorm(features)
    raise ValueError(f"Unknown norm: {name}")


class ConvNorm(nn.Module):
    """conv + optional norm + optional ReLU (``layers.py:89-120``).

    Padding is symmetric ``k // 2``: the JAX ResNet pads that way
    explicitly, and for stride 1 it equals the JAX heads' SAME padding.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 norm: str = "", relu: bool = False,
                 use_bias: Optional[bool] = None):
        super().__init__()
        use_bias = (norm == "") if use_bias is None else use_bias
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=kernel // 2, bias=use_bias)
        self.norm = get_norm(norm, out_ch)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.relu else x


class MLP(nn.Module):
    """ReLU MLP with a linear last layer (``layers.py:123-141``)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def position_embedding_sine(h: int, w: int, num_pos_feats: int,
                            device=None, temperature: float = 10000.0
                            ) -> torch.Tensor:
    """DETR 2D sine embedding, normalized (``layers.py:144-172``).

    Returns [H, W, 2*num_pos_feats] laid out as (y-features, x-features).
    """
    f32 = torch.float32
    scale = 2 * math.pi
    eps = 1e-6
    y_embed = torch.arange(1, h + 1, dtype=f32, device=device)[:, None].expand(h, w)
    x_embed = torch.arange(1, w + 1, dtype=f32, device=device)[None, :].expand(h, w)
    y_embed = y_embed / (h + eps) * scale
    x_embed = x_embed / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=f32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


def gen_sineembed_for_position(pos: torch.Tensor, temperature: float = 20.0,
                               dim: int = 128) -> torch.Tensor:
    """Sine embedding of normalized reference points (``layers.py:175-199``).

    ``pos``: [..., 2*points] in [0, 1] -> [..., 2*dim*points], laid out as
    (y-embed, x-embed) per point.
    """
    scale = 2 * math.pi
    dim_t = torch.arange(dim, dtype=pos.dtype, device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / dim)
    outs = []
    for i in range(pos.shape[-1] // 2):
        pos_x = (pos[..., 2 * i] * scale)[..., None] / dim_t
        pos_y = (pos[..., 2 * i + 1] * scale)[..., None] / dim_t
        pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                            dim=-1).flatten(-2)
        pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                            dim=-1).flatten(-2)
        outs += [pos_y, pos_x]
    return torch.cat(outs, dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))
