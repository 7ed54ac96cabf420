"""ResNet backbone with detectron2 stage naming (mirror of
``pctrans_tpu/models/resnet.py:29-113``), NCHW.

Every convolution pads symmetrically by ``k // 2``, as the JAX side does
explicitly, so odd input sizes give the same grids: 530x500 gives res2
133x125, res3 67x63, res4 34x32, res5 17x16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvNorm

BLOCKS_PER_STAGE = {14: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, bottleneck_ch: int,
                 stride: int, stride_in_1x1: bool, norm: str):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = (ConvNorm(in_ch, out_ch, 1, stride, norm, use_bias=False)
                         if in_ch != out_ch else None)
        self.conv1 = ConvNorm(in_ch, bottleneck_ch, 1, s1, norm, use_bias=False)
        self.conv2 = ConvNorm(bottleneck_ch, bottleneck_ch, 3, s3, norm,
                              use_bias=False)
        self.conv3 = ConvNorm(bottleneck_ch, out_ch, 1, 1, norm, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + shortcut)


class ResNet(nn.Module):
    """Stem (7x7/2 conv, norm, ReLU, 3x3/2 max-pool) and stages res2..res5."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = False,
                 norm: str = "FrozenBN"):
        super().__init__()
        self.stem = ConvNorm(3, 64, 7, 2, norm, use_bias=False)
        in_ch, out_ch, bott = 64, 256, 64
        self.stage_names = []
        for stage_idx, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
            name = f"res{stage_idx + 2}"
            first_stride = 1 if stage_idx == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(BottleneckBlock(
                    in_ch, out_ch, bott, first_stride if b == 0 else 1,
                    stride_in_1x1, norm))
                in_ch = out_ch
            self.add_module(name, nn.ModuleList(blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bott *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.stem(x))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outputs = {}
        for name in self.stage_names:
            for block in getattr(self, name):
                y = block(y)
            outputs[name] = y
        return outputs
