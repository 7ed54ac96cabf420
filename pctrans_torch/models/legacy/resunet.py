"""Lightweight residual 3D U-Net, ``unet_residual_3d`` (mirror of
``pctrans_tpu/models/legacy/resunet.py``), channel-first.

Anisotropic throughout: (1, k, k) convs, (1, 2, 2) strided down-sampling,
a 1x1 conv-norm-act then a 2x linear resize (align_corners=False) on the
way up, residual blocks with full (3, 3, 3) kernels, and a sigmoid on the
f32 output.  ``do_embedding`` adds the (1, 5, 5) embedding stage around the
U; without it the first level takes the input as it is and ``head_depth -
1`` residual blocks precede a 1x1 head.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import ConvNormAct, get_legacy_activation, linear_resize


class _ResidualBlock3D(nn.Module):
    """3x3x3 conv-norm-act, conv-norm, a skip projected only with
    ``projection``, the activation of the sum (``resunet.py:22-48``)."""

    def __init__(self, in_ch: int, planes: int, projection: bool = False,
                 pad_mode: str = "replicate", act_mode: str = "elu",
                 norm_mode: str = "bn"):
        super().__init__()
        shared = dict(spatial_rank=3, pad_mode=pad_mode, norm_mode=norm_mode)
        self.conv1 = ConvNormAct(in_ch, planes, 3, act_mode=act_mode, **shared)
        self.conv2 = ConvNormAct(planes, planes, 3, act_mode="none", **shared)
        self.projector = (ConvNormAct(in_ch, planes, 1, act_mode="none", **shared)
                          if projection else None)
        self.act = get_legacy_activation(act_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return self.act(y + (x if self.projector is None else self.projector(x)))


class UNetResidual3D(nn.Module):
    """``resunet.py:51-127``."""

    def __init__(self, in_channel: int = 1, out_channel: int = 3,
                 filters: Sequence[int] = (28, 36, 48, 64, 80),
                 pad_mode: str = "replicate", norm_mode: str = "bn",
                 act_mode: str = "elu", do_embedding: bool = True, head_depth: int = 1,
                 output_act: str = "sigmoid"):
        super().__init__()
        f = list(filters)
        self.depth = len(f) - 2
        self.do_embedding, self.head_depth = do_embedding, head_depth
        self.output_act = get_legacy_activation(output_act)
        shared = dict(spatial_rank=3, pad_mode=pad_mode, act_mode=act_mode,
                      norm_mode=norm_mode)
        rshared = dict(pad_mode=pad_mode, act_mode=act_mode, norm_mode=norm_mode)

        def conv(cin, cout, k, **kw):
            return ConvNormAct(cin, cout, k, **dict(shared, **kw))

        def down(ch):
            return conv(ch, ch, (1, 3, 3), strides=(1, 2, 2))

        if do_embedding:
            self.downE_conv1 = conv(in_channel, f[0], (1, 5, 5))
            self.downE_conv2 = conv(f[0], f[0], (1, 3, 3))
            self.downE_block = _ResidualBlock3D(f[0], f[0], **rshared)
            self.downS0 = down(f[0])
        else:
            f[0] = in_channel
        for i in range(self.depth):
            setattr(self, f"downC{i}_conv", conv(f[i], f[i + 1], (1, 3, 3)))
            setattr(self, f"downC{i}_block",
                    _ResidualBlock3D(f[i + 1], f[i + 1], **rshared))
            setattr(self, f"downS{i + 1}", down(f[i + 1]))
        self.center_conv = conv(f[self.depth], f[-1], (1, 3, 3))
        self.center_block = _ResidualBlock3D(f[-1], f[-1], projection=True, **rshared)
        if do_embedding:
            self.middle0 = conv(f[0], f[0], (1, 3, 3))
        for i in range(self.depth - 1, -1, -1):
            setattr(self, f"upS{i + 1}", conv(f[i + 2], f[i + 1], 1))
            setattr(self, f"upC{i}_conv", conv(f[i + 1], f[i + 1], (1, 3, 3)))
            setattr(self, f"upC{i}_block", _ResidualBlock3D(f[i + 1], f[i + 1], **rshared))
        if do_embedding:
            self.upS0 = conv(f[1], f[0], 1)
            self.upE_conv1 = conv(f[0], f[0], (1, 3, 3))
            self.upE_block = _ResidualBlock3D(f[0], f[0], **rshared)
            self.upE_out = conv(f[0], out_channel, (1, 5, 5), act_mode="none")
        else:
            for d in range(head_depth - 1):
                setattr(self, f"head_block{d}", _ResidualBlock3D(f[1], f[1], **rshared))
            self.head_out = conv(f[1], out_channel, 1, act_mode="none")

    @staticmethod
    def _up(module: nn.Module, h: torch.Tensor) -> torch.Tensor:
        h = module(h)
        return linear_resize(h, (h.shape[2], 2 * h.shape[3], 2 * h.shape[4]),
                             align_corners=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = None
        if self.do_embedding:
            z = self.downE_block(self.downE_conv2(self.downE_conv1(x)))
            x = self.downS0(z)
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"downC{i}_block")(getattr(self, f"downC{i}_conv")(x))
            skips.append(x)
            x = getattr(self, f"downS{i + 1}")(x)
        x = self.center_block(self.center_conv(x))
        if self.do_embedding:
            z = self.middle0(z)
        for i in range(self.depth - 1, -1, -1):
            x = skips[i] + self._up(getattr(self, f"upS{i + 1}"), x)
            x = getattr(self, f"upC{i}_block")(getattr(self, f"upC{i}_conv")(x))
        if self.do_embedding:
            x = z + self._up(self.upS0, x)
            x = self.upE_out(self.upE_block(self.upE_conv1(x)))
        else:
            for d in range(self.head_depth - 1):
                x = getattr(self, f"head_block{d}")(x)
            x = self.head_out(x)
        return self.output_act(x.float())
