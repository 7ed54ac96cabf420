"""2D DeepLabV3 (mirror of ``pctrans_tpu/models/legacy/deeplab.py``),
channel-first.

A dilated bottleneck ResNet (``replace_stride_with_dilation`` (False, True,
True), stride 8) with ASPP and one of three heads:

* deeplabv3a: a 3x3 conv-norm-act and a 1x1 classifier;
* deeplabv3b: a conv-norm-act, a ~2x upsample (an odd size H goes to
  2H - 1), a conv-norm-act and a biased 3x3 classifier on zero padding;
* deeplabv3c: ASPP resized onto the layer1 feature, concatenated with its
  32-channel projection, a conv-norm-act and a 1x1 classifier;

plus an optional auxiliary classifier on layer3.  Every output is resized
(align_corners=True) to the input's size: ``{"out": ..., "aux"?: ...}`` of
[B, out_channel, H, W] f32 logits.  JAX infers the input's channels; the
port takes them as ``in_channel`` (``MODEL.IN_PLANES``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .blocks import ConvNormAct, linear_resize
from .resnet_legacy import ResNet2D


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (``deeplab.py:28-55``): a 1x1 branch,
    three dilated 3x3 branches, an image-pooling branch (global mean,
    1x1 conv-norm-act, broadcast back), concatenated and projected."""

    def __init__(self, in_ch: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), pad_mode: str = "replicate",
                 act_mode: str = "elu", norm_mode: str = "bn"):
        super().__init__()
        shared = dict(spatial_rank=2, pad_mode=pad_mode, act_mode=act_mode,
                      norm_mode=norm_mode)
        self.n_rates = len(atrous_rates)
        self.conv1x1 = ConvNormAct(in_ch, out_channels, 1, **shared)
        for i, rate in enumerate(atrous_rates):
            setattr(self, f"atrous{i}", ConvNormAct(in_ch, out_channels, 3, dilation=rate,
                                                    **shared))
        self.pool_conv = ConvNormAct(in_ch, out_channels, 1, **shared)
        self.project = ConvNormAct(out_channels * (self.n_rates + 2), out_channels, 1,
                                   **shared)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.conv1x1(x)]
        branches += [getattr(self, f"atrous{i}")(x) for i in range(self.n_rates)]
        pooled = self.pool_conv(x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        return self.project(torch.cat(branches, dim=1))


class DeepLabV3(nn.Module):
    """``name_variant`` picks the head, as the reference's ``head_map``
    (``deeplab.py:58-129``)."""

    def __init__(self, name_variant: str = "deeplabv3a", in_channel: int = 1,
                 out_channel: int = 1, aux_out: bool = False,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 pad_mode: str = "replicate", act_mode: str = "elu",
                 norm_mode: str = "bn"):
        super().__init__()
        if name_variant not in ("deeplabv3a", "deeplabv3b", "deeplabv3c"):
            raise ValueError(f"Unknown DeepLabV3 variant: {name_variant}")
        self.variant, self.aux_out = name_variant, aux_out
        self.backbone = ResNet2D(in_channel, layers=backbone_layers,
                                 replace_stride_with_dilation=(False, True, True),
                                 norm_mode=norm_mode, act_mode=act_mode, aux_out=aux_out,
                                 low_level_feat=name_variant == "deeplabv3c")
        shared = dict(spatial_rank=2, pad_mode=pad_mode, act_mode=act_mode,
                      norm_mode=norm_mode)
        self.aspp = ASPP(2048, 256, pad_mode=pad_mode, act_mode=act_mode,
                         norm_mode=norm_mode)
        if name_variant == "deeplabv3a":
            self.head_conv = ConvNormAct(256, 256, 3, **shared)
            self.classifier = nn.Conv2d(256, out_channel, 1)
        elif name_variant == "deeplabv3b":
            self.head_conv1 = ConvNormAct(256, 128, 3, **shared)
            self.head_conv2 = ConvNormAct(128, 128, 3, **shared)
            self.classifier = nn.Conv2d(128, out_channel, 3, padding=1)
        else:
            self.low_proj = ConvNormAct(256, 32, 1, **shared)
            self.head_conv = ConvNormAct(256 + 32, 256, 3, **shared)
            self.classifier = nn.Conv2d(256, out_channel, 1)
        if aux_out:
            self.aux_conv = ConvNormAct(1024, 256, 3, **shared)
            self.aux_classifier = nn.Conv2d(256, out_channel, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        in_hw = x.shape[2:]
        feats = self.backbone(x)
        y = self.aspp(feats["out"])
        if self.variant == "deeplabv3a":
            y = self.classifier(self.head_conv(y))
        elif self.variant == "deeplabv3b":
            y = self.head_conv1(y)
            up = [2 * n - 1 if n % 2 else 2 * n for n in y.shape[2:]]
            y = self.head_conv2(linear_resize(y, up, align_corners=True))
            y = self.classifier(y)
        else:
            low = feats["low_level_feat"]
            y = linear_resize(y, low.shape[2:], align_corners=True)
            y = torch.cat([y, self.low_proj(low)], dim=1)
            y = self.classifier(self.head_conv(y))
        out = {"out": linear_resize(y, in_hw, align_corners=True).float()}
        if self.aux_out:
            a = self.aux_classifier(self.aux_conv(feats["aux"]))
            out["aux"] = linear_resize(a, in_hw, align_corners=True).float()
        return out
