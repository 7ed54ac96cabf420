"""Swin Transformer backbone (mirror of ``pctrans_tpu/models/swin.py``):
Mask2Former's Swin-T behind ``MODEL.BACKBONE.NAME == 'D2SwinTransformer'``.

Tokens are [B, L, C]; ``SwinTransformer(images [B, 3, H, W])`` returns the
``{"res2".."res5"}`` maps at strides 4/8/16/32, NCHW, at the widths
``SwinTransformer.channels`` names (96/192/384/768 for Swin-T).

As in the JAX package: attention logits and softmax in f32, the MLP's GELU
is the tanh form (flax ``nn.gelu``; the original PyTorch Swin uses the erf
form, ROADMAP §C.14), a block whose map is no larger than its window runs
one unshifted window of the map's size, and drop path keeps or drops each
sample's whole branch, scaled by 1/keep.  Drop path draws from the
``generator`` that ``forward`` is given (the train step's) and draws
nothing in eval mode.

Each attention block keeps the relative-position table of its configured
window, so one module serves every input size; at a clamped window only
the table's central offsets are read.  JAX sizes that table to the clamped
window at init, and the weight bridge places it at the centre.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .layers import LayerNorm


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C] (``swin.py:30-34``)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C] (``swin.py:37-42``)."""
    C = wins.shape[-1]
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def relative_position_index(ws: int, table_ws: Optional[int] = None) -> np.ndarray:
    """[N, N] index of each token pair's offset into the bias table of a
    ``table_ws`` window (by default ``ws``; ``swin.py:45-54``)."""
    t = ws if table_ws is None else table_ws
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (t - 1)
    return rel[:, :, 0] * (2 * t - 1) + rel[:, :, 1]


def shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """0/-100 f32 mask between the regions a cyclic shift brings into one
    window (``swin.py:57-68``): [nW, N, N]."""
    img = torch.zeros(Hp, Wp, dtype=torch.int32, device=device)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    wins = window_partition(img[None, :, :, None], ws)[..., 0]       # [nW, N]
    differ = wins[:, None, :] != wins[:, :, None]
    return torch.where(differ, -100.0, 0.0).float()


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
              ) -> torch.Tensor:
    """Zero each sample's branch with probability ``rate``, scale the kept
    ones by 1 / (1 - rate): flax ``nn.Dropout(rate, broadcast_dims=(1, 2))``
    on [B, L, C] (``swin.py:160-165``).  Across ranks the draw is the
    global batch's, sliced to this rank's rows."""
    keep = 1.0 - rate
    draw = mesh.rank_rows(torch.rand((x.shape[0] * mesh.world_size(), 1, 1),
                                     generator=generator, device=x.device))
    return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias (``swin.py:71-109``)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("index", torch.from_numpy(
            relative_position_index(window_size)), persistent=False)

    def forward(self, x: torch.Tensor, ws: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        Bn, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(Bn, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-1, -2)).float()
        idx = self.index if ws == self.window_size else torch.from_numpy(
            relative_position_index(ws, self.window_size)).to(x.device)
        bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(N, N, H)
        attn = attn + bias.permute(2, 0, 1)[None].float()
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
                    ).reshape(Bn, H, N, N)
        attn = attn.softmax(-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(Bn, N, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    """One (shifted-)window block (``swin.py:112-172``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.shift_size, self.drop_path = window_size, shift_size, drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, qk_scale)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self._masks: Dict[tuple, torch.Tensor] = {}     # shift masks by grid

    def _drop(self, h: torch.Tensor, generator) -> torch.Tensor:
        if self.drop_path == 0.0 or not self.training:
            return h
        return drop_path(h, self.drop_path, generator)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        H, W = hw
        B, L, C = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(H, W) <= ws:       # window no smaller than the map: no shift
            shift, ws = 0, min(H, W)

        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
            key = (Hp, Wp, ws, shift, x.device)
            if key not in self._masks:
                self._masks[key] = shift_attn_mask(Hp, Wp, ws, shift, x.device)
            mask = self._masks[key]
        x = window_reverse(self.attn(window_partition(x, ws), ws, mask), ws, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), (1, 2))
        x = x[:, :H, :W].reshape(B, L, C)

        x = shortcut + self._drop(x, generator)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))
        return x + self._drop(y, generator)


class PatchMerging(nn.Module):
    """2x2 merge: concat the neighbours x0, x1, x2, x3, norm, linear to 2C;
    odd sizes padded first (``swin.py:175-195``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        H, W = hw
        B, L, C = x.shape
        x = F.pad(x.reshape(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(B, -1, 4 * C)))


class SwinTransformer(nn.Module):
    """Patch embed, four stages of Swin blocks with patch merging between
    them, a LayerNorm per output (``swin.py:198-264``)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.3,
                 patch_size: int = 4):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = LayerNorm(embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.channels = {f"res{i + 2}": d for i, d in enumerate(dims)}
        first = np.cumsum([0, *depths])
        self.blocks = nn.ModuleList(
            nn.ModuleList(
                SwinBlock(dim, heads, window_size,
                          shift_size=0 if b % 2 == 0 else window_size // 2,
                          mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                          drop_path=float(dpr[first[i] + b]))
                for b in range(depth))
            for i, (dim, heads, depth) in enumerate(zip(dims, num_heads, depths)))
        self.downsample = nn.ModuleList(PatchMerging(d) for d in dims[:-1])
        self.out_norm = nn.ModuleList(LayerNorm(d) for d in dims)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        ps = self.patch_size
        H0, W0 = images.shape[-2:]
        x = F.pad(images, (0, (ps - W0 % ps) % ps, 0, (ps - H0 % ps) % ps))
        x = self.patch_embed(x)
        B, C, Wh, Ww = x.shape
        x = self.patch_norm(x.flatten(2).transpose(1, 2))
        hw = (Wh, Ww)
        outs = {}
        for i, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x, hw, generator)
            y = self.out_norm[i](x)
            outs[f"res{i + 2}"] = y.transpose(1, 2).reshape(B, y.shape[-1], *hw)
            if i < len(self.downsample):
                x = self.downsample[i](x, hw)
                hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
        return outs
