"""DETR transformer predictor (mirror of ``pctrans_tpu/models/detr_decoder.py``),
``MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME == 'StandardTransformerDecoder'``.

``dec_layers`` post-norm decoder layers run learned queries over the
flattened input map; each layer's output, through the shared
``decoder_norm``, is projected by a 3-layer MLP to ``mask_dim`` and
contracted with the pixel embedding into mask logits.  Masks only: no
reference points, so the PCTrans criterion cannot train it
(``engine/train_step.py`` refuses).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .fpn_decoder import MultiHeadAttention, TransformerEncoderLayerPostNorm
from .layers import MLP, position_embedding_sine


class TransformerDecoderLayerPostNorm(nn.Module):
    """Query self-attention, cross-attention to the memory, FFN, each with a
    residual and a LayerNorm (``detr_decoder.py:30-59``)."""

    def __init__(self, d_model: int, nheads: int, d_ffn: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nheads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.multihead_attn = MultiHeadAttention(d_model, nheads)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, memory, pos):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class StandardTransformerDecoder(nn.Module):
    """``forward(x [B, C_in, H, W], mask_features [B, mask_dim, Hm, Wm])`` ->
    ``pred_masks`` [B, Q, Hm, Wm] f32, ``aux_masks`` (the earlier layers'
    under deep supervision), and with ``mask_classification``
    ``pred_logits`` [B, Q, num_classes + 1] and ``aux_logits``
    (``detr_decoder.py:62-146``)."""

    def __init__(self, in_channels: int, hidden_dim: int = 128,
                 num_queries: int = 100, nheads: int = 8,
                 dim_feedforward: int = 1024, enc_layers: int = 0,
                 dec_layers: int = 10, mask_dim: int = 16, num_classes: int = 1,
                 mask_classification: bool = True, deep_supervision: bool = True,
                 enforce_input_project: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.mask_classification = mask_classification
        self.deep_supervision = deep_supervision
        self.input_proj = (nn.Conv2d(in_channels, hidden_dim, 1)
                           if in_channels != hidden_dim or enforce_input_project else None)
        self.encoder_layer = nn.ModuleList(
            TransformerEncoderLayerPostNorm(hidden_dim, nheads, dim_feedforward)
            for _ in range(enc_layers))
        self.query_embed = nn.Parameter(torch.empty(num_queries, hidden_dim))
        self.decoder_layer = nn.ModuleList(
            TransformerDecoderLayerPostNorm(hidden_dim, nheads, dim_feedforward)
            for _ in range(dec_layers))
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)
        if mask_classification:
            self.class_embed = nn.Linear(hidden_dim, num_classes + 1)

    def forward(self, x: torch.Tensor, mask_features: torch.Tensor) -> Dict:
        if self.input_proj is not None:
            x = self.input_proj(x)
        B, d, H, W = x.shape
        src = x.flatten(2).transpose(1, 2)
        pos = position_embedding_sine(H, W, d // 2, x.device).reshape(1, H * W, d)
        pos = pos.to(src.dtype)
        for layer in self.encoder_layer:
            src = layer(src, pos)
        query_pos = self.query_embed[None].expand(B, -1, -1)
        tgt = torch.zeros_like(query_pos)
        intermediate = []
        for layer in self.decoder_layer:
            tgt = layer(tgt, query_pos, src, pos)
            intermediate.append(self.decoder_norm(tgt))

        def masks_of(hs):
            emb = self.mask_embed(hs)                          # [B, Q, mask_dim]
            return torch.einsum("bqc,bchw->bqhw", emb, mask_features.to(emb.dtype)).float()

        out = {}
        if self.mask_classification:
            out["pred_logits"] = self.class_embed(intermediate[-1]).float()
        if not self.deep_supervision:
            out["pred_masks"] = masks_of(intermediate[-1])
            out["aux_masks"] = []
            return out
        masks = [masks_of(hs) for hs in intermediate]
        out["pred_masks"], out["aux_masks"] = masks[-1], masks[:-1]
        if self.mask_classification:
            out["aux_logits"] = [self.class_embed(hs).float() for hs in intermediate[:-1]]
        return out
