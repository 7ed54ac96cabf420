"""BotNet-3D backbone (mirror of ``pctrans_tpu/models/legacy/botnet.py``),
channel-first.

ResNet3D stages 0-3, then a stage of three bottleneck blocks whose 3x3
conv is multi-head self-attention over every (z, h, w) position with a
learned absolute (h, w) position embedding shared across z; the first
block average-pools (1, 2, 2) after its attention.

The one difference from the JAX API: flax sizes the embeddings
``pos_emb_h`` [H, dim_head] and ``pos_emb_w`` [W, dim_head] from the input
the stage sees at init, so the port takes the model's input size
``input_size`` (D, H, W) at construction and derives each block's (H, W)
from it: block 0 sees 2x the H and W of blocks 1-2.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ConvNormAct, apply_norm, get_legacy_activation, get_legacy_norm
from .resnet_legacy import FEATURE_KEYS, ResNet3D


class BotAttention(nn.Module):
    """MHSA over the Z*H*W tokens with the (h, w) embedding added to the
    keys (``botnet.py:24-56``); the softmax in f32."""

    def __init__(self, in_ch: int, hw: Tuple[int, int], heads: int = 4,
                 dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Conv3d(in_ch, heads * dim_head * 3, 1, bias=False)
        self.pos_emb_h = nn.Parameter(torch.empty(hw[0], dim_head))
        self.pos_emb_w = nn.Parameter(torch.empty(hw[1], dim_head))
        nn.init.normal_(self.pos_emb_h, std=dim_head ** -0.5)
        nn.init.normal_(self.pos_emb_w, std=dim_head ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, Z, H, W = x.shape
        if (H, W) != (self.pos_emb_h.shape[0], self.pos_emb_w.shape[0]):
            raise ValueError(f"BotAttention: a {H}x{W} map, embeddings for "
                             f"{self.pos_emb_h.shape[0]}x{self.pos_emb_w.shape[0]} "
                             "(the model's input_size sets them)")
        hd, inner = self.dim_head, self.heads * self.dim_head
        q, k, v = self.to_qkv(x).flatten(2).transpose(1, 2).chunk(3, dim=-1)
        pos = (self.pos_emb_h[:, None] + self.pos_emb_w[None]).reshape(H * W, hd)
        pos = pos.repeat(Z, 1).to(x.dtype)                       # shared across z
        q = q.reshape(B, -1, self.heads, hd) * hd ** -0.5
        k = k.reshape(B, -1, self.heads, hd)
        v = v.reshape(B, -1, self.heads, hd)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k)
                  + torch.einsum("bqhd,kd->bhqk", q, pos))
        attn = logits.float().softmax(-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return out.reshape(B, Z, H, W, inner).permute(0, 4, 1, 2, 3)


class BottleBlock(nn.Module):
    """Attention bottleneck (``botnet.py:59-97``): 1x1 conv-norm-act to
    ``dim_out // proj_factor``, attention (``heads * dim_head`` channels
    out), an optional (1, 2, 2) average pool, norm, act, 1x1 conv-norm to
    ``dim_out``, and a pooled, projected skip."""

    def __init__(self, in_ch: int, dim_out: int, hw: Tuple[int, int],
                 proj_factor: int = 2, heads: int = 4, dim_head: int = 32,
                 downsample: bool = False, act_mode: str = "elu", norm_mode: str = "bn"):
        super().__init__()
        self.downsample = downsample
        self.act = get_legacy_activation(act_mode)
        inner = heads * dim_head
        self.conv_in = ConvNormAct(in_ch, dim_out // proj_factor, 1, spatial_rank=3,
                                   norm_mode=norm_mode, act_mode=act_mode)
        self.attn = BotAttention(dim_out // proj_factor, hw, heads, dim_head)
        self.norm0 = get_legacy_norm(norm_mode, inner, 3)
        self.conv_out = ConvNormAct(inner, dim_out, 1, spatial_rank=3,
                                    norm_mode=norm_mode, act_mode="none")
        self.shortcut = (ConvNormAct(in_ch, dim_out, 1, spatial_rank=3,
                                     norm_mode=norm_mode, act_mode="none")
                         if in_ch != dim_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(self.conv_in(x))
        shortcut = x
        if self.downsample:
            y = F.avg_pool3d(y, (1, 2, 2), (1, 2, 2))
            shortcut = F.avg_pool3d(shortcut, (1, 2, 2), (1, 2, 2))
        y = self.conv_out(self.act(apply_norm(self.norm0, y)))
        if self.shortcut is not None:
            shortcut = self.shortcut(shortcut)
        return self.act(y + shortcut)


def bottle_stack_hw(input_size: Sequence[int], n_stages: int) -> Tuple[int, int]:
    """(H, W) of the bottleneck stage's input: the input's (H, W) halved,
    rounding up (a SAME conv of stride 2), once per ResNet stage 1 to
    ``n_stages - 2``."""
    h, w = (int(s) for s in input_size[-2:])
    for _ in range(n_stages - 2):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


class BotNet3D(ResNet3D):
    """ResNet3D stages 0-3 and the 3-block bottleneck stage ``layer4``
    (``botnet.py:100-139``) over an input of ``input_size`` (D, H, W)."""

    def __init__(self, input_size: Sequence[int], in_channel: int = 1,
                 block_type: str = "residual",
                 filters: Sequence[int] = (28, 36, 48, 64, 80),
                 blocks: Sequence[int] = (2, 2, 2, 2),
                 isotropy: Sequence[bool] = (False, False, False, True, True),
                 pad_mode: str = "replicate", act_mode: str = "elu",
                 norm_mode: str = "bn", feature_keys: Sequence[str] = FEATURE_KEYS):
        super().__init__(in_channel, block_type, filters[:-1], blocks, isotropy, pad_mode,
                         act_mode, norm_mode, feature_keys)
        h, w = bottle_stack_hw(input_size, len(filters))
        names = [f"layer4_block{b}" for b in range(3)]
        for b, name in enumerate(names):
            setattr(self, name, BottleBlock(
                filters[-2] if b == 0 else filters[-1], filters[-1],
                (h, w) if b == 0 else (h // 2, w // 2), downsample=b == 0,
                act_mode=act_mode, norm_mode=norm_mode))
        self.stages.append(names)
