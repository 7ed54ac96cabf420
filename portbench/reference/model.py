"""The plain reference of the PCTrans recipe: ResNet-50, the MSDeformAttn
pixel decoder and the position-guided masked decoder, with every kernel
replaced by its plain PyTorch form (``ops.py``).

A frozen copy of the port's own twin path (``pctrans_torch/models/
pctrans.py``, ``resnet.py``, ``pixel_decoder.py``, ``transformer_decoder.py``,
``layers.py``), which the CPU tests held to the JAX package; it imports
nothing of the port, so a later change to the port cannot move it.  Only
the recipe's components are kept (no Swin, FPN or DETR).

``precision`` selects how the convolutions and projections compute:

* ``"config"``: as the configuration states (bf16 autocast for
  ``dtype == "bfloat16"``, with the f32 islands fixed in each module; every
  other product in f32 with TF32 off, which the caller sets);
* ``"fp8"``: the control: besides, every ``nn.Linear`` / ``nn.Conv2d``
  input and weight rounded to float8 e4m3 with one scale per tensor (the
  largest magnitude at 448), the step below bf16 that a later change might
  take; the gradient passes straight through the rounding.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .pixel_decoder import MSDeformAttn, MSDeformAttnPixelDecoder, sampling_offset_bias
from .resnet import STAGE_CHANNELS, ResNet
from .transformer_decoder import MultiScaleMaskedTransformerDecoder

PRECISIONS = ("config", "fp8")
FP8_MAX = 448.0          # the largest float8 e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per tensor, back in its
    dtype; the gradient passes straight through."""
    with torch.no_grad():
        scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def _fp8_linear(self, x):
    return F.linear(fp8_round(x), fp8_round(self.weight), self.bias)


def _fp8_conv(self, x):
    return self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias)


class PCTransReference(nn.Module):
    def __init__(self, config: ModelConfig, generator: Optional[torch.Generator] = None,
                 precision: str = "config"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        c = self.config = config
        self.precision = precision
        self.backbone = ResNet(c.backbone_depth, c.stride_in_1x1, c.backbone_norm)
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            STAGE_CHANNELS, conv_dim=c.conv_dim, norm=c.head_norm,
            transformer_layers=c.enc_layers, n_heads=c.nheads,
            n_points=c.enc_points, fpn_legacy_swap=c.fpn_legacy_swap)
        self.predictor = MultiScaleMaskedTransformerDecoder(
            c.conv_dim, hidden_dim=c.hidden_dim, num_queries=c.num_queries,
            nheads=c.nheads, dim_feedforward=c.dim_feedforward,
            dec_layers=c.dec_layers, mask_dim=c.mask_dim,
            points_num=c.points_num, sem_loss_on=c.sem_loss_on,
            sem_norm=c.head_norm, rel_coord=c.rel_coord,
            upsample2x=c.upsample2x)
        init_weights(self, generator)
        if precision == "fp8":
            for m in self.modules():
                if type(m) is nn.Linear:
                    m.forward = _fp8_linear.__get__(m)
                elif type(m) is nn.Conv2d:
                    m.forward = _fp8_conv.__get__(m)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        """images: [B, H, W, 3] f32 -> the port's output dict."""
        c = self.config
        mean = torch.tensor(c.pixel_mean, device=images.device)
        std = torch.tensor(c.pixel_std, device=images.device)
        images = (images.float() - mean) / std
        x = images.permute(0, 3, 1, 2).contiguous()
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=c.dtype == "bfloat16"):
            feats = self.backbone(x)
            mask_features, _, multi_scale = self.pixel_decoder(feats)
            out = self.predictor(multi_scale, mask_features)
        out["mask_features"] = mask_features.permute(0, 2, 3, 1).float()
        return out


_EMBEDDINGS = ("level_embed", "query_feat", "query_embed")


def _fans(w: torch.Tensor):
    receptive = w[0][0].numel() if w.ndim > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Seeded random weights with the JAX initializers' distributions, drawn
    in two large calls on the generator's device (one normal and one
    uniform draw over every leaf that takes one): Kaiming fan-out normal for
    the ResNet's convolutions; Xavier-uniform for every other dense layer
    and head convolution (Kaiming-uniform, a=1, for the mask and seg
    heads); N(0, 1/fan_in) for ``sem_logits``; N(0, 1) embeddings; zero
    biases, the directional bias for sampling offsets, zero offset and
    attention-weight projections, identity norms."""
    deform = [m for m in model.modules() if isinstance(m, MSDeformAttn)]
    zeroed = {id(m.sampling_offsets.weight) for m in deform} | {
        id(m.attention_weights.weight) for m in deform}
    normal, uniform = [], []            # (leaf, scale) of each draw's share
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Linear, nn.Conv2d)):
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)
        w = m.weight
        fan_in, fan_out = _fans(w)
        if id(w) in zeroed:
            nn.init.zeros_(w)
        elif name.startswith("backbone."):
            normal.append((w, math.sqrt(2.0 / fan_out)))
        elif name.endswith(("mask_head", "seg_head.0.conv", "seg_head.1.conv")):
            uniform.append((w, math.sqrt(3.0 / fan_in)))
        elif name.endswith("sem_logits"):
            normal.append((w, fan_in ** -0.5))
        else:
            uniform.append((w, math.sqrt(6.0 / (fan_in + fan_out))))
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in _EMBEDDINGS:
            normal.append((p, 1.0))
    device = generator.device if generator is not None else next(model.parameters()).device
    for leaves, draw in ((normal, torch.randn), (uniform, torch.rand)):
        flat = draw(sum(w.numel() for w, _ in leaves), generator=generator, device=device)
        if draw is torch.rand:
            flat = flat * 2.0 - 1.0
        start = 0
        for w, scale in leaves:
            w.copy_(flat[start:start + w.numel()].view_as(w) * scale)
            start += w.numel()
    for m in deform:
        m.sampling_offsets.bias.copy_(torch.from_numpy(sampling_offset_bias(
            m.n_heads, m.n_levels, m.n_points)))
    for m in model.modules():
        if getattr(m, "sem_loss_on", False):
            # prior probability 0.01 (transformer_decoder.py:258-262)
            nn.init.constant_(m.sem_logits.bias, -math.log((1 - 0.01) / 0.01))
