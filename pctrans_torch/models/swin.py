"""Swin Transformer backbone (mirror of ``pctrans_tpu/models/swin.py``):
Mask2Former's Swin behind ``MODEL.BACKBONE.NAME == 'D2SwinTransformer'``,
sized by the ``MODEL.SWIN`` node (Swin-T by default; Swin-L is embed 192,
depths (2, 2, 18, 2), heads (6, 12, 24, 48), window 12).

Tokens are [B, L, C]; ``SwinTransformer(images [B, 3, H, W])`` returns the
``{"res2".."res5"}`` maps at strides 4/8/16/32, NCHW, at the widths
``SwinTransformer.channels`` names (96/192/384/768 for Swin-T).  The
attention between each block's qkv projection and ``proj`` is chosen
explicitly, never by what the tensors happen to be: a train-mode forward
runs the twin under autograd (K6 has no backward, ROADMAP D.10); an
eval-mode forward calls K6 (``ops/window_attn.py``), which on a CUDA
tensor raises for what it cannot take (a dtype other than bf16, heads
other than 32 wide, a window over 12, inputs that need a gradient) and
on a CPU tensor or inside ``ops._build.twins()`` runs the twin; a backbone built
with ``attention="twin"`` (an f32 configuration: K6 is bf16 only) runs
the twin in both modes.

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

from ..ops.window_attn import (relative_position_index, shift_attn_mask,  # noqa: F401
                                window_attention, window_attention_twin)
from ..parallel import mesh
from .graphs import hand_kernel
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


ATTENTION = ("kernel", "twin")


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias (``swin.py:71-109``).  Between
    the qkv projection and ``proj``: in eval mode K6 through
    ``graphs.hand_kernel`` (the wrapper takes the twin on a CPU tensor or
    inside ``ops._build.twins()``, and raises on a CUDA tensor it cannot take); in
    train mode, or with ``kernel=False``, the twin under autograd."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 kernel: bool = True):
        super().__init__()
        self.num_heads, self.window_size, self.kernel = num_heads, window_size, kernel
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, ws: int, shift: int = 0,
                grid: Tuple[int, int] = (1, 1)) -> torch.Tensor:
        """x: [B*nW, ws*ws, C], the windows of ``grid`` (nWh, nWw) per image
        after a cyclic shift by ``shift``."""
        qkv = self.qkv(x)
        args = (qkv, self.relative_position_bias_table, self.num_heads, ws,
                self.window_size, shift, grid, self.scale)
        if self.training or not self.kernel:
            # K6 has no backward (ROADMAP D.10): training runs the twin under autograd
            out = window_attention_twin(*args)
        else:
            out = hand_kernel(__name__, "window_attention", *args)
        return self.proj(out)


class SwinBlock(nn.Module):
    """One (shifted-)window block (``swin.py:112-172``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path: float = 0.0,
                 kernel: bool = True):
        super().__init__()
        self.window_size, self.shift_size, self.drop_path = window_size, shift_size, drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, qk_scale, kernel)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

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
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        x = window_reverse(self.attn(window_partition(x, ws), ws, shift,
                                     (Hp // ws, Wp // ws)), ws, Hp, Wp)
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
    them, a LayerNorm per output (``swin.py:198-264``).  ``attention``:
    ``"kernel"`` (K6 in eval mode) or ``"twin"`` (the twin in every mode)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.3,
                 patch_size: int = 4, attention: str = "kernel"):
        super().__init__()
        if attention not in ATTENTION:
            raise ValueError(f"SwinTransformer: attention {attention!r}, not one of {ATTENTION}")
        self.patch_size, self.attention = patch_size, attention
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
                          drop_path=float(dpr[first[i] + b]),
                          kernel=attention == "kernel")
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
