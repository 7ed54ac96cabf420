"""3D feature pyramid network (mirror of
``pctrans_tpu/models/legacy/fpn3d.py``), channel-first.

A backbone (resnet, repvgg, botnet or efficientnet) gives five stage
features; 1x1 laterals bring each to ``filters[0]`` channels; top-down, the
coarser map is trilinearly resized (align_corners=True) onto the next
lateral, smoothed (a conv-norm-act at the stage's isotropy) and added;
a last smooth and the biased io conv ``conv_out`` give f32 logits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .blocks import ConvNormAct, linear_resize
from .botnet import BotNet3D
from .efficientnet import EfficientNet3D
from .repvgg import RepVGG3D
from .resnet_legacy import ResNet3D


class FPN3D(nn.Module):
    """``input_size`` (D, H, W) is the model's input size; only the botnet
    backbone needs it (its position embeddings are sized from it)."""

    def __init__(self, backbone_type: str = "resnet", block_type: str = "residual",
                 in_channel: int = 1, out_channel: int = 3,
                 filters: Sequence[int] = (28, 36, 48, 64, 80),
                 blocks: Sequence[int] = (2, 2, 2, 2), is_isotropic: bool = False,
                 isotropy: Sequence[bool] = (False, False, False, True, True),
                 pad_mode: str = "replicate", act_mode: str = "elu",
                 norm_mode: str = "bn", deploy: bool = False,
                 input_size: Optional[Sequence[int]] = None):
        super().__init__()
        depth = len(filters)
        self.isotropy = [True] * depth if is_isotropic else list(isotropy)
        keys = tuple(f"feat{i + 1}" for i in range(depth))
        self.keys = keys
        common = dict(in_channel=in_channel, filters=filters, isotropy=self.isotropy,
                      pad_mode=pad_mode, act_mode=act_mode, feature_keys=keys)
        if backbone_type == "resnet":
            self.backbone = ResNet3D(block_type=block_type, blocks=blocks,
                                     norm_mode=norm_mode, **common)
        elif backbone_type == "repvgg":
            self.backbone = RepVGG3D(blocks=blocks, deploy=deploy, **common)
        elif backbone_type == "botnet":
            if input_size is None:
                raise ValueError("FPN3D: the botnet backbone needs input_size")
            self.backbone = BotNet3D(input_size, block_type=block_type, blocks=blocks,
                                     norm_mode=norm_mode, **common)
        elif backbone_type == "efficientnet":
            self.backbone = EfficientNet3D(
                blocks=tuple(blocks) + (2,) * max(0, depth - len(blocks)),
                norm_mode=norm_mode, **common)
        else:
            raise ValueError(f"Unsupported FPN3D backbone: {backbone_type}")
        shared = dict(spatial_rank=3, pad_mode=pad_mode, act_mode=act_mode,
                      norm_mode=norm_mode)
        for i in range(depth):
            setattr(self, f"lat{i}", ConvNormAct(filters[i], filters[0], 1, **shared))
            setattr(self, f"smooth{i}", ConvNormAct(
                filters[0], filters[0], (3, 3, 3) if self.isotropy[i] else (1, 3, 3),
                **shared))
        self.conv_out = ConvNormAct(filters[0], out_channel,
                                    (5, 5, 5) if self.isotropy[0] else (1, 5, 5),
                                    spatial_rank=3, use_bias=True, pad_mode=pad_mode,
                                    norm_mode="none", act_mode="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        depth = len(self.keys)
        lat = [getattr(self, f"lat{i}")(feats[k]) for i, k in enumerate(self.keys)]
        out = lat[-1]
        for i in range(depth - 1, 0, -1):
            up = linear_resize(out, lat[i - 1].shape[2:], align_corners=True)
            out = getattr(self, f"smooth{i}")(up) + lat[i - 1]
        return self.conv_out(self.smooth0(out)).float()
