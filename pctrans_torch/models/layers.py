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

from ..parallel import mesh


def in_f32(fn, *xs: torch.Tensor):
    """``fn(*xs)`` on f32 copies of ``xs`` with autocast off: a flax module
    without a dtype promotes its input with its f32 parameters and computes
    in f32 under the bf16 recipe too, on the CPU and the card alike."""
    with torch.autocast(xs[0].device.type, enabled=False):
        return fn(*(x.float() for x in xs))


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
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` (``layers.py:73-79``)
    over [N, C, *spatial] with 1 to 3 spatial dims.

    Train mode normalises with the batch statistics and updates the running
    ones with momentum 0.1 from the *biased* batch variance, as flax does
    (``nn.BatchNorm2d`` would use the unbiased one).  Eval mode uses the
    running statistics.  Both compute in f32 with autocast off and return
    f32, whatever the input's dtype: flax's BatchNorm carries no dtype, so
    it promotes a bf16 input with its f32 scale.

    ``sync`` (SyncBN): under a process group of more than one rank the
    statistics are the global batch's, as JAX computes them over the
    batch-sharded mesh: the per-channel sum and count, then the sum of
    squared deviations from the global mean, all-reduced in f32 with the
    gradient flowing through (``nn.SyncBatchNorm`` would update the running
    variance with the unbiased one).
    """

    def __init__(self, features: int, sync: bool = False):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.sync = sync

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if not 3 <= x.dim() <= 5:
            raise ValueError(f"BatchNorm: expected 3D-5D input, got {x.dim()}D")

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach() * m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        return in_f32(self._normalize, x)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.sync and mesh.is_distributed():
            return self._synced(x)
        dims = [0] + list(range(2, x.dim()))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
        self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = (-1,) + (1,) * (x.dim() - 2)
        count = torch.full((1,), x.numel() / x.shape[1], dtype=torch.float32,
                           device=x.device)
        sums = mesh.all_reduce_sum(torch.cat([x.sum(dims), count]))
        n = sums[-1]
        mean = sums[:-1] / n
        centred = x - mean.view(shape)
        var = mesh.all_reduce_sum((centred * centred).sum(dims)) / n
        self._update_running(mean, var)
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(epsilon=1e-5)`` with flax's dtypes, whatever
    autocast's op lists say (CPU autocast leaves ``group_norm`` in bf16,
    CUDA autocast runs it in f32): statistics and affine in f32 with
    autocast off; the output in the input's dtype with ``keep_dtype`` (a
    flax norm given ``dtype=self.dtype``, fed the compute dtype), else f32
    (a flax norm with no dtype promotes the input with its f32 scale)."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-5,
                 keep_dtype: bool = False, affine: bool = True):
        super().__init__(num_groups, features, eps=eps, affine=affine)
        self.keep_dtype = keep_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = in_f32(super().forward, x)
        return y.to(x.dtype) if self.keep_dtype else y


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-5)`` with flax's dtypes, as
    :class:`GroupNorm`: f32 statistics and affine; the input's dtype with
    ``keep_dtype``, else f32."""

    def __init__(self, features: int, eps: float = 1e-5, keep_dtype: bool = False):
        super().__init__(features, eps=eps)
        self.keep_dtype = keep_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = in_f32(super().forward, x)
        return y.to(x.dtype) if self.keep_dtype else y


def get_norm(name: str, features: int) -> Optional[nn.Module]:
    """detectron2 ``get_norm`` mirror (``layers.py:64-86``): BN and SyncBN
    are :class:`BatchNorm` (eps 1e-5; SyncBN's statistics are the global
    batch's across ranks), GN has 32 groups; both give f32, as JAX's norms
    without a dtype do.  FrozenBN keeps the activation dtype."""
    if not name:
        return None
    if name in ("BN", "SyncBN"):
        return BatchNorm(features, sync=name == "SyncBN")
    if name == "GN":
        return GroupNorm(32, features)
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


class Conv2dF32(nn.Conv2d):
    """A flax ``nn.Conv`` without a dtype (``sem_logits``,
    ``transformer_decoder.py:260-261``): it promotes its input to f32 and
    computes in f32 under the bf16 recipe too, so this runs with autocast
    off on an f32 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_f32(super().forward, x)


class MLP(nn.Module):
    """ReLU MLP with a linear last layer (``layers.py:123-141``).

    JAX's ``MLP`` carries ``dtype=float32`` unless given the compute dtype,
    so its Dense layers cast their input to f32 and compute in f32 under the
    bf16 recipe too: with ``fp32`` the forward runs with autocast off on an
    f32 input and returns f32; without it (JAX's ``dtype=dtype``) it runs in
    the ambient autocast dtype."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, fp32: bool = True):
        super().__init__()
        self.fp32 = fp32
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_f32(self._layers, x) if self.fp32 else self._layers(x)

    def _layers(self, x: torch.Tensor) -> torch.Tensor:
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
