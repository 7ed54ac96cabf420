"""RepVGG-3D backbone with its train-to-deploy fusion (mirror of
``pctrans_tpu/models/legacy/repvgg.py``), channel-first.

Train mode sums three branches per block: a 3x3 (or (1, 3, 3)) conv and
its BatchNorm, a 1x1 conv and its BatchNorm, and a BatchNorm of the input
where shapes allow.  Deploy mode is one biased conv, ``rbr_reparam``, whose
weights :func:`repvgg_convert` fuses from the three.  The BatchNorms are
BatchNorm (momentum 0.9, eps 1e-5) whatever ``norm_mode`` the model has.
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..layers import BatchNorm
from .blocks import get_legacy_activation, pad_spatial
from .resnet_legacy import FEATURE_KEYS


class RepVGGBlock3D(nn.Module):
    """One RepVGG block (``repvgg.py:27-62``)."""

    def __init__(self, in_ch: int, planes: int, strides: Tuple[int, int, int] = (1, 1, 1),
                 isotropic: bool = False, pad_mode: str = "zeros",
                 act_mode: str = "relu", deploy: bool = False):
        super().__init__()
        self.k = (3, 3, 3) if isotropic else (1, 3, 3)
        self.strides = tuple(strides)
        self.pad_mode = pad_mode
        self.act = get_legacy_activation(act_mode)
        self.deploy = deploy
        if deploy:
            self.rbr_reparam = nn.Conv3d(in_ch, planes, self.k, stride=self.strides)
            return
        self.rbr_dense_conv = nn.Conv3d(in_ch, planes, self.k, stride=self.strides,
                                        bias=False)
        self.rbr_dense_bn = BatchNorm(planes, sync=True)
        self.rbr_1x1_conv = nn.Conv3d(in_ch, planes, 1, stride=self.strides, bias=False)
        self.rbr_1x1_bn = BatchNorm(planes, sync=True)
        self.rbr_identity_bn = (BatchNorm(in_ch, sync=True)
                                if in_ch == planes and all(s == 1 for s in self.strides)
                                else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = pad_spatial(x, self.k, (1, 1, 1), self.pad_mode)
        if self.deploy:
            return self.act(self.rbr_reparam(h))
        y = (self.rbr_dense_bn(self.rbr_dense_conv(h))
             + self.rbr_1x1_bn(self.rbr_1x1_conv(x)))
        if self.rbr_identity_bn is not None:
            y = y + self.rbr_identity_bn(x)
        return self.act(y)

    @torch.no_grad()
    def fused(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The deploy conv's (weight, bias) (``repvgg.py:99-131``): each
        branch's BatchNorm (running statistics) folded into its kernel, the
        1x1 kernel at the centre tap, the identity a delta kernel at the
        centre tap of channel ``i % cin``."""
        def fold(kernel, bn):
            t = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            return kernel * t.view(-1, 1, 1, 1, 1), bn.bias - bn.running_mean * t

        kernel, bias = fold(self.rbr_dense_conv.weight, self.rbr_dense_bn)
        k1, b1 = fold(self.rbr_1x1_conv.weight, self.rbr_1x1_bn)
        centre = ((self.k[0] - 1) // 2, 1, 1)
        kernel = kernel.clone()
        kernel[(...,) + centre] += k1[..., 0, 0, 0]
        bias = bias + b1
        if self.rbr_identity_bn is not None:
            cout, cin = kernel.shape[:2]
            ident = torch.zeros_like(kernel)
            for i in range(cout):
                ident[(i, i % cin) + centre] = 1.0
            ki, bi = fold(ident, self.rbr_identity_bn)
            kernel, bias = kernel + ki, bias + bi
        return kernel, bias

    def to_deploy_(self) -> None:
        """Replace the three branches by the fused ``rbr_reparam``."""
        weight, bias = self.fused()
        cout, cin = weight.shape[:2]
        conv = nn.Conv3d(cin, cout, self.k, stride=self.strides).to(weight.device)
        with torch.no_grad():
            conv.weight.copy_(weight)
            conv.bias.copy_(bias)
        for name in ("rbr_dense_conv", "rbr_dense_bn", "rbr_1x1_conv", "rbr_1x1_bn",
                     "rbr_identity_bn"):
            delattr(self, name)
        self.rbr_reparam = conv
        self.deploy = True


class RepVGG3D(nn.Module):
    """5-stage RepVGG backbone (``repvgg.py:65-96``); returns the per-stage
    feature dict (feat1..feat5)."""

    def __init__(self, in_channel: int = 1, filters: Sequence[int] = (28, 36, 48, 64, 80),
                 blocks: Sequence[int] = (4, 4, 4, 4),
                 isotropy: Sequence[bool] = (False, False, False, True, True),
                 pad_mode: str = "replicate", act_mode: str = "elu", deploy: bool = False,
                 feature_keys: Sequence[str] = FEATURE_KEYS):
        super().__init__()
        self.feature_keys = tuple(feature_keys)
        shared = dict(pad_mode=pad_mode, act_mode=act_mode, deploy=deploy)
        self.layer0_block0 = RepVGGBlock3D(in_channel, filters[0], isotropic=isotropy[0],
                                           **shared)
        self.stages = [["layer0_block0"]]
        for s in range(1, len(filters)):
            iso = isotropy[s]
            names = [f"layer{s}_block{b}" for b in range(max(blocks[s - 1], 1))]
            setattr(self, names[0], RepVGGBlock3D(
                filters[s - 1], filters[s], (2, 2, 2) if iso else (1, 2, 2), iso, **shared))
            for name in names[1:]:
                setattr(self, name, RepVGGBlock3D(filters[s], filters[s], isotropic=iso,
                                                  **shared))
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = {}
        for key, names in zip(self.feature_keys, self.stages):
            for name in names:
                x = getattr(self, name)(x)
            feats[key] = x
        return feats


def repvgg_convert(model: nn.Module) -> nn.Module:
    """A deploy-mode copy of ``model``: every train-mode
    :class:`RepVGGBlock3D` in it, at any depth, fused into its
    ``rbr_reparam`` from its running statistics; every other module and
    buffer as it was.

    JAX's ``repvgg_convert`` (``repvgg.py:134-144``) takes a RepVGG3D's own
    variables and fuses only the blocks at the top of that tree; for an
    FPN3D it is applied to ``params["backbone"]``, and the rest of the
    tree keeps its ``batch_stats``.  Both give the same deploy model."""
    out = copy.deepcopy(model)
    for m in [m for m in out.modules() if isinstance(m, RepVGGBlock3D) and not m.deploy]:
        m.to_deploy_()
    return out
