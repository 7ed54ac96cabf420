"""PCTrans meta-architecture, recipe path (mirror of
``pctrans_tpu/models/pctrans.py:140-289``): pixel normalisation, ResNet,
MSDeformAttn pixel decoder, position-guided transformer decoder.

``PCTransModel(config)(images [B, H, W, 3])`` returns the JAX model's dict:

  pred_masks           [B, Q, H/4, W/4]  final mask logits (compute dtype)
  aux_masks            list of dec_layers earlier [B, Q, H/4, W/4]
  reference_points     [B, Q, 2]
  aux_reference_points list of dec_layers - 1 [B, Q, 2]
  query_emb            [B, Q, C] f32
  sem_mask             [B, H/4, W/4, 1] f32 or None
  mask_features        [B, H/4, W/4, C] f32

With ``config.dtype == "bfloat16"`` the forward runs under
``torch.autocast`` in bf16 (the JAX recipe's mixed precision); sampling
locations, attention softmaxes and the render stay f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig, validate
from .pixel_decoder import MSDeformAttn, MSDeformAttnPixelDecoder, sampling_offset_bias
from .resnet import STAGE_CHANNELS, ResNet
from .transformer_decoder import MultiScaleMaskedTransformerDecoder


class PCTransModel(nn.Module):
    def __init__(self, config: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        validate(config)
        c = self.config = config
        self.backbone = ResNet(c.backbone_depth, c.stride_in_1x1, c.backbone_norm)
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            STAGE_CHANNELS, conv_dim=c.conv_dim, norm=c.head_norm,
            transformer_layers=c.enc_layers, n_heads=c.nheads,
            n_points=c.enc_points)
        self.predictor = MultiScaleMaskedTransformerDecoder(
            c.conv_dim, hidden_dim=c.hidden_dim, num_queries=c.num_queries,
            nheads=c.nheads, dim_feedforward=c.dim_feedforward,
            dec_layers=c.dec_layers, mask_dim=c.mask_dim,
            points_num=c.points_num, sem_loss_on=c.sem_loss_on,
            sem_norm=c.head_norm, rel_coord=c.rel_coord,
            upsample2x=c.upsample2x)
        init_weights(self, generator)

    def forward(self, images: torch.Tensor,
                impl: Optional[str] = None) -> Dict[str, Any]:
        """images: [B, H, W, 3] f32.  ``impl="twin"`` runs every kernel's
        plain twin (for kernel-vs-twin comparisons on the card)."""
        c = self.config
        mean = torch.tensor(c.pixel_mean, device=images.device)
        std = torch.tensor(c.pixel_std, device=images.device)
        images = (images.float() - mean) / std
        x = images.permute(0, 3, 1, 2).contiguous()
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.config.dtype == "bfloat16"):
            feats = self.backbone(x)
            mask_features, multi_scale = self.pixel_decoder(feats, impl=impl)
            out = self.predictor(multi_scale, mask_features, impl=impl)
        out["mask_features"] = mask_features.permute(0, 2, 3, 1).float()
        return out


def init_weights(model: PCTransModel,
                 generator: Optional[torch.Generator] = None) -> None:
    """Seeded random init with the JAX initializers' distributions: Kaiming
    fan-out normal for backbone convs, Xavier-uniform for dense layers and
    head convs, zero biases, N(0, 1) embeddings, the directional bias for
    sampling offsets, identity norms."""
    g = generator
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                if name.startswith("backbone."):
                    nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                            nonlinearity="relu", generator=g)
                elif name.endswith(("mask_head", "seg_head.0.conv", "seg_head.1.conv")):
                    nn.init.kaiming_uniform_(m.weight, a=1.0, generator=g)
                elif name.endswith("sem_logits"):
                    fan_in = m.weight[0].numel()
                    nn.init.normal_(m.weight, std=fan_in ** -0.5, generator=g)
                else:
                    nn.init.xavier_uniform_(m.weight, generator=g)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                nn.init.zeros_(m.sampling_offsets.weight)
                m.sampling_offsets.bias.copy_(torch.from_numpy(sampling_offset_bias(
                    m.n_heads, m.n_levels, m.n_points)))
                nn.init.zeros_(m.attention_weights.weight)
        pred = model.predictor
        for p in (model.pixel_decoder.level_embed, pred.query_feat,
                  pred.query_embed, pred.level_embed):
            nn.init.normal_(p, generator=g)
        if pred.sem_loss_on:
            # prior probability 0.01 (transformer_decoder.py:258-262)
            nn.init.constant_(pred.sem_logits.bias, -math.log((1 - 0.01) / 0.01))
