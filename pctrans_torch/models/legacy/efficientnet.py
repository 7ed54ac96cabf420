"""EfficientNet-3D backbone (mirror of
``pctrans_tpu/models/legacy/efficientnet.py``), channel-first.

Five stages of depthwise inverted-residual blocks: per block a 1x1 expand,
a depthwise k x k x k (or 1 x k x k) conv, optional squeeze-and-excitation
and a 1x1 project, with an average-pooled, projected skip on strided
blocks.  Stage strides (1, 2, 2, (1, 2, 2), 2).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (SELayer, apply_norm, get_legacy_activation, get_legacy_norm,
                     pad_spatial)
from .resnet_legacy import FEATURE_KEYS


def _to3(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class InvertedResidual3D(nn.Module):
    """Expand, depthwise conv (``groups = mid``), SE, project
    (``efficientnet.py:25-78``).  The norms are ``norm0..norm3`` in flax's
    call order: after the expand, the depthwise conv, the project and the
    skip's projector."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 strides: Union[int, Sequence[int]] = 1, expansion_factor: int = 1,
                 attention: str = "squeeze_excitation", isotropic: bool = False,
                 pad_mode: str = "replicate", act_mode: str = "elu",
                 norm_mode: str = "bn"):
        super().__init__()
        mid = in_ch * expansion_factor
        self.k = (kernel_size,) * 3 if isotropic else (1, kernel_size, kernel_size)
        self.strides = _to3(strides)
        self.pad_mode = pad_mode
        self.act = get_legacy_activation(act_mode)
        self.expand = nn.Conv3d(in_ch, mid, 1, bias=False)
        self.norm0 = get_legacy_norm(norm_mode, mid, 3)
        self.dwconv = nn.Conv3d(mid, mid, self.k, stride=self.strides, groups=mid,
                                bias=False)
        self.norm1 = get_legacy_norm(norm_mode, mid, 3)
        self.se = SELayer(mid) if attention == "squeeze_excitation" else None
        self.project = nn.Conv3d(mid, out_ch, 1, bias=False)
        self.norm2 = get_legacy_norm(norm_mode, out_ch, 3)
        self.projector = None
        if any(s != 1 for s in self.strides) or in_ch != out_ch:
            self.projector = nn.Conv3d(in_ch, out_ch, 1, bias=False)
            self.norm3 = get_legacy_norm(norm_mode, out_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(apply_norm(self.norm0, self.expand(x)))
        y = self.dwconv(pad_spatial(y, self.k, (1, 1, 1), self.pad_mode))
        y = self.act(apply_norm(self.norm1, y))
        if self.se is not None:
            y = self.se(y)
        y = apply_norm(self.norm2, self.project(y))
        shortcut = x
        if any(s != 1 for s in self.strides):
            shortcut = F.avg_pool3d(shortcut, self.strides, self.strides)
        if self.projector is not None:
            shortcut = apply_norm(self.norm3, self.projector(shortcut))
        if shortcut.shape[2:] != y.shape[2:]:
            # an odd size under a stride: the conv ceils, the pool floors;
            # edge-pad the skip at the end of each axis
            pads = [p for ys, ss in zip(reversed(y.shape[2:]), reversed(shortcut.shape[2:]))
                    for p in (0, ys - ss)]
            shortcut = F.pad(shortcut, pads, mode="replicate")
        return y + shortcut


class EfficientNet3D(nn.Module):
    """A 3x3x3 stem conv-norm-act, then five stages of
    :class:`InvertedResidual3D` (``efficientnet.py:81-118``); returns the
    per-stage feature dict (feat1..feat5)."""

    STRIDES = (1, 2, 2, (1, 2, 2), 2)

    def __init__(self, in_channel: int = 1, filters: Sequence[int] = (32, 64, 96, 128, 160),
                 blocks: Sequence[int] = (1, 2, 2, 2, 4),
                 ks: Sequence[int] = (3, 3, 5, 3, 3),
                 isotropy: Sequence[bool] = (False, False, False, True, True),
                 attention: str = "squeeze_excitation", pad_mode: str = "replicate",
                 act_mode: str = "elu", norm_mode: str = "bn",
                 feature_keys: Sequence[str] = FEATURE_KEYS):
        super().__init__()
        self.feature_keys = tuple(feature_keys)
        self.pad_mode = pad_mode
        self.act = get_legacy_activation(act_mode)
        self.conv1 = nn.Conv3d(in_channel, filters[0], 3, bias=False)
        self.norm0 = get_legacy_norm(norm_mode, filters[0], 3)
        self.stages = []
        ch = filters[0]
        for s in range(len(filters)):
            names = [f"layer{s}_block{b}" for b in range(blocks[s])]
            for b, name in enumerate(names):
                setattr(self, name, InvertedResidual3D(
                    ch, filters[s], kernel_size=ks[s],
                    strides=self.STRIDES[s] if b == 0 else 1, attention=attention,
                    isotropic=isotropy[s], pad_mode=pad_mode, act_mode=act_mode,
                    norm_mode=norm_mode))
                ch = filters[s]
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.conv1(pad_spatial(x, (3, 3, 3), (1, 1, 1), self.pad_mode))
        x = self.act(apply_norm(self.norm0, x))
        feats = {}
        for key, names in zip(self.feature_keys, self.stages):
            for name in names:
                x = getattr(self, name)(x)
            feats[key] = x
        return feats
