"""Position-guided masked transformer decoder (mirror of
``pctrans_tpu/models/transformer_decoder.py``).

Object queries carry 2D reference points refined per layer; a query sine
embedding is concatenated per head with the content query, so
cross-attention runs at 2*d for Q/K while values stay at d; masks come from
a CondInst dynamic 1x1-conv head (the K3 render in eval, its einsum twin
in train mode) and, thresholded at sigmoid 0.5, mask the next layer's
cross-attention.  Feature levels are visited
round-robin.

Dtypes follow the JAX modules' under the bf16 recipe, on the CPU and the
card alike (``pctrans_tpu/models/transformer_decoder.py``): the attention,
FFN and mask-head projections run in the compute dtype (autocast), their
residual input cast to it first (``tgt.astype(dt)``); the LayerNorms carry
no dtype there, so the query stream between layers is f32; the four MLP
heads (``ref_point_head``, ``query_scale``, ``point_embed``,
``controller``) and ``sem_logits`` run in f32, the seg head's norms give
f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.render import dynamic_mask_render, render_twin  # noqa: F401  (see hand_kernel)
from ..ops.resize import resize_bilinear
from .graphs import hand_kernel
from .layers import (MLP, Conv2dF32, ConvNorm, LayerNorm, device_constant,
                     gen_sineembed_for_position, inverse_sigmoid, position_embedding_sine)

NEG_INF = -1e9


def attention(q, k, v, nheads: int, bias: Optional[torch.Tensor] = None):
    """Multi-head attention with projected q/k/v (``_attention`` ``:57-78``).

    q, k: [B, Lq/Lk, E]; v: [B, Lk, Ev]; ``bias``: additive [B, Lq, Lk].
    Scaling is (E // nheads) ** -0.5 on q; logits and softmax run in f32.
    """
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    hd = E // nheads
    q = q.reshape(B, Lq, nheads, hd).transpose(1, 2) * (hd ** -0.5)
    k = k.reshape(B, Lk, nheads, hd).transpose(1, 2)
    v = v.reshape(B, Lk, nheads, Ev // nheads).transpose(1, 2)
    logits = torch.matmul(q, k.transpose(-1, -2)).float()
    if bias is not None:
        logits = logits + bias[:, None].float()
    w = logits.softmax(-1).to(v.dtype)
    return torch.matmul(w, v).transpose(1, 2).reshape(B, Lq, Ev)


class SelfAttentionLayer(nn.Module):
    def __init__(self, d: int, nheads: int):
        super().__init__()
        self.nheads = nheads
        for name in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
                     "sa_kpos_proj", "sa_v_proj", "out_proj"):
            self.add_module(name, nn.Linear(d, d))
        self.norm1 = LayerNorm(d)

    def forward(self, tgt, query_pos):
        q = self.sa_qcontent_proj(tgt) + self.sa_qpos_proj(query_pos)
        k = self.sa_kcontent_proj(tgt) + self.sa_kpos_proj(query_pos)
        v = self.sa_v_proj(tgt)
        out = self.out_proj(attention(q, k, v, self.nheads))
        return self.norm1(tgt.to(out.dtype) + out)


class CrossAttentionLayer(nn.Module):
    """Decoupled cross-attention at 2*d (``:103-147``); the query-position
    projection exists only in the first layer."""

    def __init__(self, d: int, nheads: int, points_num: int, is_first: bool):
        super().__init__()
        self.nheads = nheads
        for name in ("ca_qcontent_proj", "ca_kcontent_proj", "ca_v_proj",
                     "ca_kpos_proj", "out_proj"):
            self.add_module(name, nn.Linear(d, d))
        self.ca_qpos_proj = nn.Linear(d, d) if is_first else None
        self.ca_qpos_sine_proj = nn.Linear(2 * d * points_num, d)
        self.norm2 = LayerNorm(d)

    def forward(self, tgt, memory, pos, query_pos, query_sine_embed, attn_bias):
        B, Q, d = tgt.shape
        S, h = memory.shape[1], self.nheads
        q = self.ca_qcontent_proj(tgt)
        k = self.ca_kcontent_proj(memory)
        v = self.ca_v_proj(memory)
        k_pos = self.ca_kpos_proj(pos)
        if self.ca_qpos_proj is not None:
            q = q + self.ca_qpos_proj(query_pos)
            k = k + k_pos
        sine = self.ca_qpos_sine_proj(query_sine_embed)
        q = torch.cat([q.reshape(B, Q, h, d // h), sine.reshape(B, Q, h, d // h)],
                      3).reshape(B, Q, 2 * d)
        k = torch.cat([k.reshape(B, S, h, d // h), k_pos.reshape(B, S, h, d // h)],
                      3).reshape(B, S, 2 * d)
        out = self.out_proj(attention(q, k, v, h, bias=attn_bias))
        return self.norm2(tgt.to(out.dtype) + out)


class FFNLayer(nn.Module):
    def __init__(self, d: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d)
        self.norm = LayerNorm(d)

    def forward(self, tgt):
        y = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm(tgt.to(y.dtype) + y)


class MultiScaleMaskedTransformerDecoder(nn.Module):
    def __init__(self, in_channels: int, hidden_dim: int = 128,
                 num_queries: int = 100, nheads: int = 8,
                 dim_feedforward: int = 1024, dec_layers: int = 9,
                 mask_dim: int = 16, points_num: int = 1,
                 sem_loss_on: bool = True, sem_norm: str = "SyncBN",
                 rel_coord: bool = True, upsample2x: bool = False,
                 dynamic_mask_channels: int = 8, mask_feat_stride: int = 4,
                 num_feature_levels: int = 3):
        super().__init__()
        d = hidden_dim
        self.hidden_dim, self.num_queries = d, num_queries
        self.dec_layers, self.rel_coord = dec_layers, rel_coord
        self.upsample2x = upsample2x
        self.ch, self.stride = dynamic_mask_channels, mask_feat_stride
        self.num_feature_levels = num_feature_levels
        self.query_feat = nn.Parameter(torch.empty(num_queries, d))
        self.query_embed = nn.Parameter(torch.empty(num_queries, d))
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d))
        self.cross_layers = nn.ModuleList(
            CrossAttentionLayer(d, nheads, points_num, i == 0)
            for i in range(dec_layers))
        self.self_layers = nn.ModuleList(
            SelfAttentionLayer(d, nheads) for _ in range(dec_layers))
        self.ffn_layers = nn.ModuleList(
            FFNLayer(d, dim_feedforward) for _ in range(dec_layers))
        self.decoder_norm = LayerNorm(d)
        self.ref_point_head = MLP(d, d, points_num * 2, 2)
        self.query_scale = MLP(d, d * 2, d * 2 * points_num, 2)
        self.point_embed = MLP(d, d, 2 * points_num, 3)
        cin = mask_dim + (2 if rel_coord else 0)
        ch = dynamic_mask_channels
        self.split_sizes = [cin * ch, ch * ch, ch, ch, ch, 1]  # w1 w2 w3 b1 b2 b3
        self.controller = MLP(d, d, sum(self.split_sizes), 3)
        self.mask_head = nn.Conv2d(in_channels, mask_dim, 1)
        self.sem_loss_on = sem_loss_on
        if sem_loss_on:
            self.seg_head = nn.ModuleList([
                ConvNorm(in_channels, d, 3, norm=sem_norm, relu=True, use_bias=False),
                ConvNorm(d, d, 3, norm=sem_norm, relu=True, use_bias=False)])
            self.sem_logits = Conv2dF32(d, 1, 1)

    def forward(self, x: Sequence[torch.Tensor], mask_features: torch.Tensor) -> Dict:
        """x: [res5', res4', res3'] NCHW; mask_features NCHW at stride 4."""
        B = x[0].shape[0]
        d = self.hidden_dim
        src, pos, size_list = [], [], []
        for i, xi in enumerate(x):
            H, W = xi.shape[-2:]
            size_list.append((H, W))
            pe = position_embedding_sine(H, W, d // 2, xi.device).reshape(H * W, d)
            pos.append(pe[None].expand(B, -1, -1).to(xi.dtype))
            src.append(xi.flatten(2).transpose(1, 2)
                       + self.level_embed[i].to(xi.dtype))

        query_embed = self.query_embed[None].expand(B, -1, -1)
        output = self.query_feat[None].expand(B, -1, -1)
        reference_points = torch.sigmoid(self.ref_point_head(query_embed))
        ref_points_list = [reference_points]

        sem_mask = None
        if self.sem_loss_on:
            y = mask_features
            for layer in self.seg_head:
                y = layer(y)
            sem_mask = self.sem_logits(y).permute(0, 2, 3, 1)
        mask_feat = self.mask_head(mask_features)

        predictions_mask, outputs_coords = [], []
        outputs_mask, attn_bias = self.dynamic_mask_with_coords(
            mask_feat, reference_points, self.controller(output), size_list[0])
        predictions_mask.append(outputs_mask)

        for i in range(self.dec_layers):
            sine = gen_sineembed_for_position(reference_points, dim=d)
            if i != 0:
                sine = sine * self.query_scale(output)
            level = i % self.num_feature_levels
            output = self.cross_layers[i](output, src[level], pos[level],
                                          query_embed, sine, attn_bias)
            output = self.self_layers[i](output, query_embed)
            output = self.ffn_layers[i](output)

            new_reference_points = torch.sigmoid(
                self.point_embed(output) + inverse_sigmoid(reference_points))
            if i != self.dec_layers - 1:
                ref_points_list.append(new_reference_points)
            reference_points = new_reference_points.detach()

            outputs_mask, attn_bias = self.dynamic_mask_with_coords(
                mask_feat, new_reference_points, self.controller(output),
                size_list[(i + 1) % self.num_feature_levels])
            predictions_mask.append(outputs_mask)

            coord = torch.sigmoid(self.point_embed(self.decoder_norm(output))
                                  + inverse_sigmoid(ref_points_list[i]))
            outputs_coords.append(coord)

        return {
            "pred_masks": predictions_mask[-1],
            "aux_masks": predictions_mask[:-1],
            "reference_points": outputs_coords[-1],
            "aux_reference_points": outputs_coords[:-1],
            "query_emb": output.float(),
            "sem_mask": sem_mask,
        }

    def dynamic_mask_with_coords(self, mask_feat, reference_points, params,
                                 attn_size: Tuple[int, int]):
        """Render per-query masks (``:347-461``).

        Returns (mask logits [B, Q, Hm, Wm] in the compute dtype, or
        [B, Q, 2Hm, 2Wm] with ``upsample2x``; attention bias [B, Q, h*w], 0
        or NEG_INF, with fully-masked rows reset to attend everywhere).
        """
        B, Cm, Hm, Wm = mask_feat.shape
        Q = reference_points.shape[1]
        ch, stride = self.ch, self.stride
        dtype = mask_feat.dtype
        scale = device_constant((Wm * stride, Hm * stride), mask_feat.device)
        inst_xy = reference_points[..., :2].float() * scale
        w1, w2, w3, b1, b2, b3 = torch.split(params, self.split_sizes, -1)
        w1 = w1.reshape(B, Q, ch, -1)
        w2 = w2.reshape(B, Q, ch, ch)
        w3 = w3.reshape(B, Q, 1, ch)
        feats = mask_feat.flatten(2).transpose(1, 2)          # [B, HW, Cm]
        args = (feats, inst_xy, w1, w2, w3, b1, b2, b3, (Hm, Wm), stride,
                self.rel_coord)
        # train mode renders with the einsum twin under autograd in the
        # compute dtype, as the JAX train graph does (transformer_decoder.py:
        # 398-400, 436-443); eval takes K3, which computes in f32
        mask_logits = (render_twin(*args, dtype=dtype) if self.training else
                       hand_kernel(__name__, "dynamic_mask_render", *args))
        mask_logits = mask_logits.reshape(B, Q, Hm, Wm).to(dtype)

        attn = resize_bilinear(mask_logits, attn_size)
        masked = (torch.sigmoid(attn) < 0.5).reshape(B, Q, -1)
        masked = masked & ~masked.all(-1, keepdim=True)
        attn_bias = torch.zeros(masked.shape, dtype=dtype, device=masked.device)
        attn_bias = attn_bias.masked_fill(masked, NEG_INF)

        if self.upsample2x:
            mask_logits = resize_bilinear(mask_logits, (Hm * 2, Wm * 2))
        return mask_logits, attn_bias
