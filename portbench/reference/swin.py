"""The plain reference of the Swin backbone as Mask2Former publishes it
(``D2SwinTransformer``, from the Swin Transformer paper's code): patch
embedding with a LayerNorm, four stages of (shifted-)window blocks with a
learned relative-position bias, a 2x2 patch merge between stages, and a
LayerNorm on each output (``res2`` .. ``res5``, NCHW).

Plain ``torch`` operations on what each block holds, no kernel and no
cache: each call builds the relative-position index and the shift's
region mask from the window's shape.  It computes in f32 with TF32 off (the
caller sets it, as ``compare.no_tf32``); under the configuration's bf16
autocast the dense layers compute in bf16 and the norms, logits and
softmax stay in f32, as in the program.

As published: the cyclic shift by half a window in every second block and
its region mask (-100 between tokens that the shift brings into one window
from different regions); maps padded at the bottom and right to whole
windows; a block whose map is no larger than its window runs one unshifted
window of the map's smaller side; odd maps padded before a merge; drop path
on each residual branch in training.  One departure: the MLP's GELU is the
tanh form, as the port's and the JAX package's are; the original uses the
erf form.

Its parameter names are the port's (``pctrans_torch/models/swin.py``), so
the weights drawn for the reference load into the program unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm


def to_windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * (H/ws) * (W/ws), ws*ws, C], windows in row order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def from_windows(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.reshape(-1, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


def position_index(ws: int, table_ws: int) -> np.ndarray:
    """[N, N]: the row of the (2t-1)^2 table that holds token i's offset to
    token j in a ``ws`` window, t the table's window."""
    ys, xs = np.divmod(np.arange(ws * ws), ws)
    dy = ys[:, None] - ys[None, :] + table_ws - 1
    dx = xs[:, None] - xs[None, :] + table_ws - 1
    return dy * (2 * table_ws - 1) + dx


def region_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """[nW, N, N] f32: -100 between tokens of one shifted window that come
    from different regions of the padded map, 0 elsewhere."""
    def regions(n):
        return np.where(np.arange(n) < n - ws, 0, np.where(np.arange(n) < n - shift, 1, 2))
    ids = regions(Hp)[:, None] * 3 + regions(Wp)[None, :]
    wins = ids.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(wins[:, :, None] != wins[:, None, :], -100.0, 0.0).astype(np.float32)


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
              ) -> torch.Tensor:
    """Each sample's branch kept with probability 1 - rate and scaled by
    1 / (1 - rate), one draw per sample from ``generator``."""
    keep = 1.0 - rate
    draw = torch.rand((x.shape[0], 1, 1), generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, ws: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
        Bn, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(Bn, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        logits = (q @ k.transpose(-1, -2)).float()
        idx = torch.from_numpy(position_index(ws, self.window_size)).to(x.device)
        bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(N, N, H)
        logits = logits + bias.permute(2, 0, 1).float()[None]
        if mask is not None:
            nW = mask.shape[0]
            logits = (logits.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
                      ).reshape(Bn, H, N, N)
        weights = torch.softmax(logits, -1).to(v.dtype)
        return self.proj((weights @ v).transpose(1, 2).reshape(Bn, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 drop_path: float):
        super().__init__()
        self.window_size, self.shift_size, self.drop_path = window_size, shift_size, drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)

    def _drop(self, h, generator):
        if not self.training or self.drop_path == 0.0:
            return h
        return drop_path(h, self.drop_path, generator)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        H, W = hw
        B, L, C = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(H, W) <= ws:
            ws, shift = min(H, W), 0
        y = self.norm1(x).reshape(B, H, W, C)
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = torch.from_numpy(region_mask(Hp, Wp, ws, shift)).to(x.device)
        y = from_windows(self.attn(to_windows(y, ws), ws, mask), ws, Hp, Wp)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + self._drop(y[:, :H, :W].reshape(B, L, C), generator)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))
        return x + self._drop(y, generator)


class PatchMerging(nn.Module):
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
    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 window_size: int, drop_path_rate: float, patch_size: int = 4):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = LayerNorm(embed_dim)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.channels = {f"res{i + 2}": d for i, d in enumerate(dims)}
        rates = np.linspace(0, drop_path_rate, sum(depths))
        first = np.cumsum([0, *depths])
        self.blocks = nn.ModuleList(
            nn.ModuleList(SwinBlock(dim, heads, window_size,
                                    0 if b % 2 == 0 else window_size // 2,
                                    float(rates[first[i] + b]))
                          for b in range(depth))
            for i, (dim, heads, depth) in enumerate(zip(dims, num_heads, depths)))
        self.downsample = nn.ModuleList(PatchMerging(d) for d in dims[:-1])
        self.out_norm = nn.ModuleList(LayerNorm(d) for d in dims)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        ps = self.patch_size
        H0, W0 = images.shape[-2:]
        x = self.patch_embed(F.pad(images, (0, -W0 % ps, 0, -H0 % ps)))
        B, C, H, W = x.shape
        x = self.patch_norm(x.flatten(2).transpose(1, 2))
        outs = {}
        for i, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x, (H, W), generator)
            y = self.out_norm[i](x)
            outs[f"res{i + 2}"] = y.transpose(1, 2).reshape(B, -1, H, W)
            if i < len(self.downsample):
                x = self.downsample[i](x, (H, W))
                H, W = (H + 1) // 2, (W + 1) // 2
        return outs
