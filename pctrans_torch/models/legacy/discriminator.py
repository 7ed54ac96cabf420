"""3D PatchGAN discriminator (mirror of
``pctrans_tpu/models/legacy/discriminator.py``), channel-first.

Five conv-norm-act stages with (an)isotropic kernels and strides (an
anisotropic stage never strides z), then a biased 3x3x3 conv to one
channel of patch logits in f32; trained against by
:class:`pctrans_torch.losses.legacy.GANLoss`.  JAX infers the input's
channels; the port takes them as ``in_channel``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import apply_norm, get_legacy_activation, get_legacy_norm, pad_spatial


class Discriminator3D(nn.Module):
    """``discriminator.py:18-60``: stage ``n`` is ``layer{n}_conv`` and its
    norm ``norm{n}`` (flax's ``BatchNorm_n``; ``in`` is an affine-free
    GroupNorm of one channel per group, without parameters)."""

    def __init__(self, in_channel: int = 1,
                 filters: Sequence[int] = (64, 64, 128, 128, 256),
                 pad_mode: str = "replicate", act_mode: str = "leaky_relu",
                 norm_mode: str = "in", dilation: int = 1, is_isotropic: bool = False,
                 isotropy: Sequence[bool] = (False, False, False, True, True),
                 stride_list: Sequence[int] = (2, 2, 2, 2, 1)):
        super().__init__()
        depth = len(filters)
        isotropy = [True] * depth if is_isotropic else list(isotropy)
        self.pad_mode = pad_mode
        self.act = get_legacy_activation(act_mode)
        self.geometry = []
        ch = in_channel
        for n in range(depth):
            iso, stride, kb = isotropy[n], stride_list[n], 5 if n == 0 else 3
            k = (kb,) * 3 if iso else (1, kb, kb)
            dil = (dilation,) * 3 if iso else (1, dilation, dilation)
            s = (stride,) * 3 if iso or stride == 1 else (1, stride, stride)
            self.geometry.append((k, dil))
            setattr(self, f"layer{n}_conv", nn.Conv3d(ch, filters[n], k, stride=s,
                                                      dilation=dil,
                                                      bias=norm_mode == "none"))
            setattr(self, f"norm{n}", get_legacy_norm(norm_mode, filters[n], 3))
            ch = filters[n]
        self.patch_logits = nn.Conv3d(ch, 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for n, (k, dil) in enumerate(self.geometry):
            x = getattr(self, f"layer{n}_conv")(pad_spatial(x, k, dil, self.pad_mode))
            x = self.act(apply_norm(getattr(self, f"norm{n}"), x))
        x = pad_spatial(x, (3, 3, 3), (1, 1, 1), self.pad_mode)
        return self.patch_logits(x).float()
