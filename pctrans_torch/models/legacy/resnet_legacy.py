"""Legacy ResNet backbones (mirror of
``pctrans_tpu/models/legacy/resnet_legacy.py``), channel-first.

* :class:`ResNet3D`: five stages of residual blocks over an (an)isotropic
  volume [B, C, D, H, W]; the FPN3D backbone.  Returns the per-stage
  feature dict ``feat1..feat5``.
* :class:`ResNet2D`: torchvision's bottleneck ResNet (ResNet-50 by default)
  with ``replace_stride_with_dilation``; the DeepLabV3 backbone.  Returns
  ``out`` (layer4), ``aux`` (layer3) and ``low_level_feat`` (layer1) when
  asked for.

Module names are the flax names (``layer0``, ``layer{s}_block{b}``,
``conv1``; a module's i-th norm is ``norm{i}``), so the weight bridge maps
the two trees by a fixed rename.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (BasicBlock, BasicBlockSE, ConvNormAct, apply_norm,
                     get_legacy_activation, get_legacy_norm, pad_spatial)

_BLOCKS = {"residual": BasicBlock, "residual_se": BasicBlockSE}
FEATURE_KEYS = ("feat1", "feat2", "feat3", "feat4", "feat5")


class ResNet3D(nn.Module):
    """5-stage 3D residual backbone (``resnet_legacy.py:25-57``): the stem
    ``layer0``, then per stage a strided block (2, or (1, 2, 2) where
    anisotropic) and ``blocks[s - 1] - 1`` more; ``stages`` lists the
    blocks' names per stage."""

    def __init__(self, in_channel: int = 1, block_type: str = "residual",
                 filters: Sequence[int] = (28, 36, 48, 64, 80),
                 blocks: Sequence[int] = (2, 2, 2, 2),
                 isotropy: Sequence[bool] = (False, False, False, True, True),
                 pad_mode: str = "replicate", act_mode: str = "elu",
                 norm_mode: str = "bn", feature_keys: Sequence[str] = FEATURE_KEYS):
        super().__init__()
        self.feature_keys = tuple(feature_keys)
        shared = dict(spatial_rank=3, pad_mode=pad_mode, act_mode=act_mode,
                      norm_mode=norm_mode)
        self.layer0 = ConvNormAct(in_channel, filters[0],
                                  (5, 5, 5) if isotropy[0] else (1, 5, 5), **shared)
        self.stages = []
        block_cls = _BLOCKS[block_type]
        for s in range(1, len(filters)):
            iso = isotropy[s]
            names = [f"layer{s}_block{b}" for b in range(max(blocks[s - 1], 1))]
            setattr(self, names[0], block_cls(filters[s - 1], filters[s],
                                              strides=2 if iso else (1, 2, 2),
                                              isotropic=iso, **shared))
            for name in names[1:]:
                setattr(self, name, block_cls(filters[s], filters[s], isotropic=iso,
                                              **shared))
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.layer0(x)
        feats = {self.feature_keys[0]: x}
        for s, names in enumerate(self.stages, start=1):
            for name in names:
                x = getattr(self, name)(x)
            feats[self.feature_keys[s]] = x
        return feats


class Bottleneck2D(nn.Module):
    """torchvision's Bottleneck (1x1, 3x3, 1x1, expansion 4;
    ``resnet_legacy.py:60-91``): convs without bias on zero padding, each
    followed by its norm; a projected skip where shapes change or
    ``downsample`` asks for it."""

    def __init__(self, in_ch: int, planes: int, strides: int = 1, dilation: int = 1,
                 downsample: bool = False, norm_mode: str = "bn",
                 act_mode: str = "relu"):
        super().__init__()
        out_ch = planes * 4
        self.act = get_legacy_activation(act_mode)
        self.dilation = dilation
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.norm0 = get_legacy_norm(norm_mode, planes, 2)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=strides, dilation=dilation,
                               bias=False)
        self.norm1 = get_legacy_norm(norm_mode, planes, 2)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.norm2 = get_legacy_norm(norm_mode, out_ch, 2)
        self.downsample = None
        if downsample or in_ch != out_ch or strides != 1:
            self.downsample = nn.Conv2d(in_ch, out_ch, 1, stride=strides, bias=False)
            self.norm3 = get_legacy_norm(norm_mode, out_ch, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(apply_norm(self.norm0, self.conv1(x)))
        y = pad_spatial(y, (3, 3), (self.dilation,) * 2, "zeros")
        y = self.act(apply_norm(self.norm1, self.conv2(y)))
        y = apply_norm(self.norm2, self.conv3(y))
        if self.downsample is not None:
            x = apply_norm(self.norm3, self.downsample(x))
        return self.act(y + x)


class ResNet2D(nn.Module):
    """torchvision-style bottleneck ResNet with
    ``replace_stride_with_dilation`` (``resnet_legacy.py:94-146``).

    The stem zero-pads before its max-pool, as JAX does: under ``elu`` the
    border values are negative, and ``max_pool2d(padding=1)`` would pad with
    -inf instead."""

    def __init__(self, in_channel: int = 3, layers: Sequence[int] = (3, 4, 6, 3),
                 in_planes: int = 64,
                 replace_stride_with_dilation: Sequence[bool] = (False, True, True),
                 norm_mode: str = "bn", act_mode: str = "relu", aux_out: bool = False,
                 low_level_feat: bool = False):
        super().__init__()
        self.aux_out, self.low_level_feat = aux_out, low_level_feat
        self.act = get_legacy_activation(act_mode)
        self.conv1 = nn.Conv2d(in_channel, in_planes, 7, stride=2, bias=False)
        self.norm0 = get_legacy_norm(norm_mode, in_planes, 2)
        self.stages = []
        dilation, ch = 1, in_planes
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if li == 0 else 2
            if li > 0 and replace_stride_with_dilation[li - 1]:
                dilation *= stride
                stride = 1
            names = [f"layer{li + 1}_block{b}" for b in range(max(n, 1))]
            setattr(self, names[0], Bottleneck2D(ch, planes, stride, dilation, True,
                                                 norm_mode, act_mode))
            for name in names[1:]:
                setattr(self, name, Bottleneck2D(planes * 4, planes, 1, dilation,
                                                 norm_mode=norm_mode, act_mode=act_mode))
            self.stages.append(names)
            ch = planes * 4

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = apply_norm(self.norm0, self.conv1(pad_spatial(x, (7, 7), (1, 1), "zeros")))
        x = F.max_pool2d(F.pad(self.act(x), (1, 1, 1, 1)), 3, 2)
        feats = {}
        for li, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if li == 0 and self.low_level_feat:
                feats["low_level_feat"] = x
            if li == 2 and self.aux_out:
                feats["aux"] = x
        feats["out"] = x
        return feats
