"""Block zoo of the legacy architectures (mirror of
``pctrans_tpu/models/legacy/blocks.py``).

Channel-first and dimension-generic: ``spatial_rank`` 2 takes [B, C, H, W],
3 takes [B, C, D, H, W].  Module and attribute names follow the flax tree
(``conv``, ``projector``, ``se.fc1``, ``non_local.theta``, ...); a
block's i-th norm, flax's ``BatchNorm_i`` or ``GroupNorm_i``, is
``norm{i}``, so the weight bridge
(``pctrans_torch/weights.py::load_flax_legacy_variables``) maps the two by
a fixed rename.  The legacy models train in f32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm, GroupNorm

_PAD_MODES = {"zeros": "constant", "replicate": "replicate", "reflect": "reflect",
              "circular": "circular"}

IntOrSeq = Union[int, Sequence[int]]


def get_legacy_activation(name: str) -> Callable:
    """Activation factory (``blocks.py:22-35``); flax's ``gelu`` is the tanh
    form."""
    acts = {
        "relu": F.relu,
        "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
        "elu": F.elu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "swish": F.silu,
        "efficient_swish": F.silu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "none": lambda x: x,
    }
    return acts[name]


def get_legacy_norm(name: str, features: int,
                    spatial_rank: int = 3) -> Optional[nn.Module]:
    """Norm factory (``blocks.py:38-68``): bn / sync_bn (flax BatchNorm,
    momentum 0.9, the biased running variance; global statistics across
    ranks under a process group), in (one channel per group, no affine), gn
    (8 groups in 3D, 16 in 2D, one channel per group below that count), or
    none."""
    if name in ("bn", "sync_bn"):
        return BatchNorm(features, sync=True)
    if name == "in":
        return GroupNorm(features, features, affine=False)
    if name == "gn":
        groups = 8 if spatial_rank == 3 else 16
        if features < groups:
            groups = features
        if features % groups:
            raise ValueError(f"GN requires channels divisible into {groups} groups "
                             f"(got {features}; reference misc.py:348)")
        return GroupNorm(groups, features)
    if name == "none":
        return None
    raise ValueError(f"Unknown norm: {name}")


def _to_tuple(v: IntOrSeq, rank: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * rank
    if len(v) != rank:
        raise ValueError(f"expected {rank} values, got {tuple(v)}")
    return tuple(v)


def pad_spatial(x: torch.Tensor, kernel_size: Sequence[int],
                dilation: Sequence[int], pad_mode: str) -> torch.Tensor:
    """SAME-style padding of the spatial dims (``blocks.py:78-89``): an
    effective kernel of ``e`` pads ``e // 2`` before and ``e - e // 2``
    after, in the reference's padding mode."""
    pads = []
    for k, d in zip(kernel_size, dilation):
        eff = d * (k - 1)
        pads.append((eff // 2, eff - eff // 2))
    if all(p == (0, 0) for p in pads):
        return x
    flat = [v for p in reversed(pads) for v in p]       # last dim first
    return F.pad(x, flat, mode=_PAD_MODES[pad_mode])


def _conv(rank: int, cin: int, cout: int, kernel, stride=1, dilation=1,
          groups: int = 1, bias: bool = True) -> nn.Module:
    cls = nn.Conv2d if rank == 2 else nn.Conv3d
    return cls(cin, cout, kernel, stride=stride, dilation=dilation, groups=groups,
               bias=bias)


class ConvNormAct(nn.Module):
    """Padding, conv, norm and activation (``blocks.py:92-130``)."""

    def __init__(self, in_ch: int, features: int, kernel_size: IntOrSeq = 3,
                 spatial_rank: int = 2, strides: IntOrSeq = 1,
                 dilation: IntOrSeq = 1, groups: int = 1, use_bias: bool = False,
                 pad_mode: str = "replicate", norm_mode: str = "bn",
                 act_mode: str = "relu"):
        super().__init__()
        self.ks = _to_tuple(kernel_size, spatial_rank)
        self.dil = _to_tuple(dilation, spatial_rank)
        self.pad_mode = pad_mode
        self.conv = _conv(spatial_rank, in_ch, features, self.ks,
                          _to_tuple(strides, spatial_rank), self.dil, groups, use_bias)
        self.norm0 = get_legacy_norm(norm_mode, features, spatial_rank)
        self.act = get_legacy_activation(act_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(pad_spatial(x, self.ks, self.dil, self.pad_mode))
        if self.norm0 is not None:
            x = self.norm0(x)
        return self.act(x)


class SELayer(nn.Module):
    """Squeeze-and-excitation (``blocks.py:133-151``)."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=tuple(range(2, x.dim())))
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        return x * y.reshape(y.shape + (1,) * (x.dim() - 2))


def _needs_projection(in_ch: int, planes: int, strides, rank: int,
                      projection: bool) -> bool:
    return (in_ch != planes or any(s != 1 for s in _to_tuple(strides, rank))
            or projection)


class BasicBlock(nn.Module):
    """Residual basic block (``blocks.py:154-189``): conv-norm-act,
    conv-norm, a projected skip where shapes change, the activation of the
    sum; ``se`` puts squeeze-and-excitation before the add
    (``BasicBlockSE``, ``blocks.py:192-226``).  An anisotropic 3D block
    uses (1, 3, 3) kernels."""

    def __init__(self, in_ch: int, planes: int, spatial_rank: int = 2,
                 strides: IntOrSeq = 1, dilation: int = 1, projection: bool = False,
                 isotropic: bool = True, pad_mode: str = "replicate",
                 act_mode: str = "elu", norm_mode: str = "bn", se: bool = False):
        super().__init__()
        k = (1, 3, 3) if spatial_rank == 3 and not isotropic else 3
        shared = dict(spatial_rank=spatial_rank, pad_mode=pad_mode,
                      norm_mode=norm_mode)
        self.conv1 = ConvNormAct(in_ch, planes, k, strides=strides,
                                 dilation=dilation, act_mode=act_mode, **shared)
        self.conv2 = ConvNormAct(planes, planes, k, dilation=dilation,
                                 act_mode="none", **shared)
        self.se = SELayer(planes) if se else None
        self.projector = (ConvNormAct(in_ch, planes, 1, strides=strides,
                                      act_mode="none", **shared)
                          if _needs_projection(in_ch, planes, strides, spatial_rank,
                                               projection) else None)
        self.act = get_legacy_activation(act_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        if self.projector is not None:
            x = self.projector(x)
        return self.act(y + x)


class BasicBlockSE(BasicBlock):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, se=True, **kwargs)


class BasicBlockPA(nn.Module):
    """Pre-activation residual block (``blocks.py:229-275``): norm-act-conv
    twice (convs without bias), a projected skip, no output activation."""

    def __init__(self, in_ch: int, planes: int, spatial_rank: int = 3,
                 strides: IntOrSeq = 1, dilation: int = 1, projection: bool = False,
                 isotropic: bool = True, pad_mode: str = "replicate",
                 act_mode: str = "elu", norm_mode: str = "bn"):
        super().__init__()
        k = (1, 3, 3) if spatial_rank == 3 and not isotropic else 3
        self.ks = _to_tuple(k, spatial_rank)
        self.dil = _to_tuple(dilation, spatial_rank)
        self.pad_mode = pad_mode
        self.act = get_legacy_activation(act_mode)
        self.norm0 = get_legacy_norm(norm_mode, in_ch, spatial_rank)
        self.conv1 = _conv(spatial_rank, in_ch, planes, self.ks,
                           _to_tuple(strides, spatial_rank), self.dil, bias=False)
        self.norm1 = get_legacy_norm(norm_mode, planes, spatial_rank)
        self.conv2 = _conv(spatial_rank, planes, planes, self.ks, 1, self.dil,
                           bias=False)
        self.projector = (ConvNormAct(in_ch, planes, 1, spatial_rank=spatial_rank,
                                      strides=strides, act_mode="none",
                                      pad_mode=pad_mode, norm_mode=norm_mode)
                          if _needs_projection(in_ch, planes, strides, spatial_rank,
                                               projection) else None)

    def _norm_act_conv(self, h, norm, conv):
        if norm is not None:
            h = norm(h)
        return conv(pad_spatial(self.act(h), self.ks, self.dil, self.pad_mode))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._norm_act_conv(x, self.norm0, self.conv1)
        y = self._norm_act_conv(y, self.norm1, self.conv2)
        if self.projector is not None:
            x = self.projector(x)
        return y + x


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local block (``blocks.py:278-320``): theta, phi
    and g 1x1 projections to C/2, a softmax (in f32) over all positions, a
    1x1 ``w`` back to C, a norm and the residual."""

    def __init__(self, channels: int, spatial_rank: int = 2,
                 sub_sample: bool = False, norm_mode: str = "bn"):
        super().__init__()
        inter = max(channels // 2, 1)
        self.spatial_rank, self.sub_sample = spatial_rank, sub_sample
        self.theta = _conv(spatial_rank, channels, inter, 1)
        self.phi = _conv(spatial_rank, channels, inter, 1)
        self.g = _conv(spatial_rank, channels, inter, 1)
        self.w = _conv(spatial_rank, inter, channels, 1)
        self.norm0 = get_legacy_norm(norm_mode, channels, spatial_rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        spatial = x.shape[2:]
        theta = self.theta(x).flatten(2).transpose(1, 2)             # [B, n, c]
        phi_in = x
        if self.sub_sample:
            window = (1,) * (self.spatial_rank - 2) + (2, 2)
            pool = F.max_pool2d if self.spatial_rank == 2 else F.max_pool3d
            phi_in = pool(x, window, window)
        phi = self.phi(phi_in).flatten(2)                            # [B, c, m]
        g = self.g(phi_in).flatten(2).transpose(1, 2)                # [B, m, c]
        attn = torch.matmul(theta, phi).float().softmax(-1).to(x.dtype)
        y = torch.matmul(attn, g).transpose(1, 2).reshape(B, -1, *spatial)
        y = self.w(y)
        if self.norm0 is not None:
            y = self.norm0(y)
        return y + x


def _linear_resize_axis(x: torch.Tensor, axis: int, out_n: int,
                        align_corners: bool) -> torch.Tensor:
    in_n = x.shape[axis]
    if align_corners and out_n > 1:
        pos = torch.arange(out_n, dtype=torch.float32) * ((in_n - 1) / (out_n - 1))
    else:
        pos = (torch.arange(out_n, dtype=torch.float32) + 0.5) * (in_n / out_n) - 0.5
    pos = pos.clamp(0.0, in_n - 1).to(x.device)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=in_n - 1)
    shape = [1] * x.dim()
    shape[axis] = out_n
    t = (pos - lo).to(x.dtype).reshape(shape)
    return x.index_select(axis, lo) * (1 - t) + x.index_select(axis, hi) * t


def linear_resize(x: torch.Tensor, size: Sequence[int],
                  align_corners: bool = False) -> torch.Tensor:
    """Linear resize of the spatial dims of [B, C, *spatial]
    (``blocks.py:323-350``): torch ``interpolate``'s bilinear/trilinear
    semantics in both ``align_corners`` settings, which is
    ``F.interpolate``.  The JAX function keeps half-pixel sampling on an
    axis resized to one sample under ``align_corners`` (``F.interpolate``
    takes sample 0 there), so that case runs per axis by hand."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    if align_corners and any(o == 1 and i != 1 for o, i in zip(size, x.shape[2:])):
        for axis, out_n in enumerate(size, start=2):
            if x.shape[axis] != out_n:
                x = _linear_resize_axis(x, axis, out_n, align_corners)
        return x
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(size)]
    return F.interpolate(x, size=size, mode=mode, align_corners=align_corners)
