"""Legacy residual U-Nets (mirror of ``pctrans_tpu/models/legacy/unet.py``).

One dimension-generic module covers ``UNet3D``, ``UNet2D``, ``UNetPlus3D``
and ``UNetPlus2D`` (reference connectomics/model/arch/unet.py:14-379):

* encoder: ``conv_in`` (the io kernel), then per stage a down-sampling
  (strided conv-norm-act, or max-pooling with ``pooling``) and a residual
  block;
* decoder: per stage a conv-norm-act on the coarse map, a linear upsample
  onto the skip (``align_corners`` when the encoder down-sampled by stride,
  not with pooling, ``unet.py:131-134``) added to it, then a residual block;
* ``conv_out``: the io kernel with a bias, no norm or activation; f32 out.
* ``plus``: a non-local block at the bottleneck and, per decoder stage, a
  1x1 projection of the bottleneck upsample-added as a second skip.

3D anisotropy: ``isotropy[i]`` picks (3, 3, 3) or (1, 3, 3) kernels and
down-sampling 2 or (1, 2, 2) at stage i; ``is_isotropic`` makes every stage
isotropic.  The residual blocks are (1, 3, 3) in 3D at every stage, as the
reference never forwards the isotropy to them.  Takes [B, C, *spatial].
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (BasicBlock, BasicBlockPA, BasicBlockSE, ConvNormAct,
                     NonLocalBlock, linear_resize)

_BLOCKS = {"residual": BasicBlock, "residual_pa": BasicBlockPA,
           "residual_se": BasicBlockSE}


class UNet(nn.Module):
    def __init__(self, spatial_rank: int = 3, block_type: str = "residual",
                 in_channel: int = 1, out_channel: int = 3,
                 filters: Sequence[int] = (28, 36, 48, 64, 80),
                 is_isotropic: bool = False,
                 isotropy: Sequence[bool] = (False, False, False, True, True),
                 pad_mode: str = "replicate", act_mode: str = "elu",
                 norm_mode: str = "bn", pooling: bool = False, plus: bool = False):
        super().__init__()
        self.spatial_rank, self.pooling, self.plus = spatial_rank, pooling, plus
        self.filters = tuple(filters)
        self.iso = [spatial_rank == 2 or is_isotropic or bool(isotropy[i])
                    for i in range(len(filters))]
        # 'residual_se_pa' (BasicBlock3dPASE) folds to the SE variant
        block_cls = _BLOCKS.get(block_type, BasicBlockSE)
        shared = dict(spatial_rank=spatial_rank, pad_mode=pad_mode,
                      act_mode=act_mode, norm_mode=norm_mode)
        io_iso = is_isotropic or spatial_rank == 2
        depth = len(filters)
        self.conv_in = ConvNormAct(in_channel, filters[0], self._kernel(io_iso, True),
                                   **shared)
        for i in range(depth):
            stride = self._down(self.iso[i]) if i > 0 and not pooling else 1
            prev = filters[max(i - 1, 0)]
            setattr(self, f"down{i}_conv", ConvNormAct(
                prev, filters[i], self._kernel(self.iso[i]), strides=stride, **shared))
            setattr(self, f"down{i}_block", block_cls(
                filters[i], filters[i], isotropic=False, **shared))
        if plus:
            self.non_local = NonLocalBlock(filters[-1], spatial_rank=spatial_rank,
                                           norm_mode=norm_mode)
        for i in range(depth - 1):
            setattr(self, f"up{i}_conv", ConvNormAct(
                filters[i + 1], filters[i], self._kernel(self.iso[i + 1]), **shared))
            if plus:
                setattr(self, f"feat{i}", ConvNormAct(filters[-1], filters[i], 1,
                                                      **shared))
            setattr(self, f"up{i}_block", block_cls(
                filters[i], filters[i], isotropic=False, **shared))
        self.conv_out = ConvNormAct(filters[0], out_channel, self._kernel(io_iso, True),
                                    spatial_rank=spatial_rank, use_bias=True,
                                    pad_mode=pad_mode, norm_mode="none",
                                    act_mode="none")

    def _kernel(self, iso: bool, io: bool = False):
        k = 5 if io else 3
        if self.spatial_rank == 2 or iso:
            return k
        return (1, k, k)

    def _down(self, iso: bool):
        return 2 if self.spatial_rank == 2 or iso else (1, 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        depth = len(self.filters)
        x = self.conv_in(x)
        skips = []
        for i in range(depth):
            if i > 0 and self.pooling:
                window = self._down(self.iso[i])
                pool = F.max_pool2d if self.spatial_rank == 2 else F.max_pool3d
                x = pool(x, window, window)
            x = getattr(self, f"down{i}_block")(getattr(self, f"down{i}_conv")(x))
            if i < depth - 1:
                skips.append(x)
        feat = None
        if self.plus:
            x = feat = self.non_local(x)
        align = not self.pooling
        for i in reversed(range(depth - 1)):
            x = getattr(self, f"up{i}_conv")(x)
            x = linear_resize(x, skips[i].shape[2:], align_corners=align) + skips[i]
            if self.plus:
                f = getattr(self, f"feat{i}")(feat)
                x = linear_resize(f, x.shape[2:], align_corners=align) + x
            x = getattr(self, f"up{i}_block")(x)
        return self.conv_out(x).float()


UNet3D = functools.partial(UNet, spatial_rank=3, plus=False)
UNet2D = functools.partial(UNet, spatial_rank=2, plus=False)
UNetPlus3D = functools.partial(UNet, spatial_rank=3, plus=True)
UNetPlus2D = functools.partial(UNet, spatial_rank=2, plus=True)
