"""Swin's window attention with its relative-position bias: the plain twin
and the K6 wrapper.

K6 (``pctrans_torch/csrc/window_attn.cu``) is the port's first kernel with
no Pallas original: the JAX package leaves this attention to XLA
(``pctrans_tpu/models/swin.py:71-109``).  It computes what the twin
computes between the qkv projection and ``proj``, reading the qkv output
in place and writing the heads' outputs already transposed, with the bias
and the shift mask made from each token pair's place instead of read from
an index and a mask tensor (its header gives the bound and the design).
Forward only: a train-mode forward runs the twin under autograd, and the
wrapper refuses CUDA inputs that need a gradient (``models/swin.py`` makes
the choice).

  qkv: [B*nW, N, 3C] (N = ws*ws tokens of a window, windows in the
       image's row order, nW = nWh * nWw windows per image);
  table: [(2t - 1)^2, H], the relative-position table of the configured
       window t >= ws (a window clamped to a small map reads its central
       offsets);
  shift: the cyclic shift of the padded map (0 for a plain window);
  returns [B*nW, N, C], C = 32 H
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

HEAD_DIM = 32      # the kernel's head width (every published Swin's)
MAX_WINDOW = 12    # the kernel's largest window: 144 tokens, 9 warps


def relative_position_index(ws: int, table_ws: Optional[int] = None) -> np.ndarray:
    """[N, N] index of each token pair's offset into the bias table of a
    ``table_ws`` window (by default ``ws``; ``swin.py:45-54``)."""
    t = ws if table_ws is None else table_ws
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (t - 1)
    return rel[:, :, 0] * (2 * t - 1) + rel[:, :, 1]


@functools.lru_cache(maxsize=None)
def clamped_position_index(ws: int, table_ws: int, device: torch.device) -> torch.Tensor:
    """:func:`relative_position_index` of a ``ws`` window into a
    ``table_ws`` window's table on ``device``, built once per (ws, table,
    device) and shared, so read-only: built on every call it would be a
    host-to-device copy."""
    with torch.inference_mode(False):
        return torch.from_numpy(relative_position_index(ws, table_ws)).to(device)


def shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """0/-100 f32 mask between the regions a cyclic shift brings into one
    window (``swin.py:57-68``): [nW, N, N]."""
    img = torch.zeros(Hp, Wp, dtype=torch.int32, device=device)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    wins = img.reshape(Hp // ws, ws, Wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    differ = wins[:, None, :] != wins[:, :, None]
    return torch.where(differ, -100.0, 0.0).float()


@functools.lru_cache(maxsize=None)
def cached_shift_mask(Hp: int, Wp: int, ws: int, shift: int,
                      device: torch.device) -> torch.Tensor:
    """:func:`shift_attn_mask` built once per grid and device and shared,
    so read-only (built outside ``inference_mode``, a backward may save it)."""
    with torch.inference_mode(False):
        return shift_attn_mask(Hp, Wp, ws, shift, device)


def window_attention_twin(qkv: torch.Tensor, table: torch.Tensor, num_heads: int,
                          ws: int, table_ws: int, shift: int, grid: Tuple[int, int],
                          scale: float) -> torch.Tensor:
    """Plain PyTorch version: the logits in f32 after a product in the
    input's dtype, the table gathered by the index, the shift mask added,
    an f32 softmax cast back before the product with v."""
    Bn, N, C3 = qkv.shape
    C, H = C3 // 3, num_heads
    qkv = qkv.reshape(Bn, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * scale, qkv[1], qkv[2]
    attn = torch.matmul(q, k.transpose(-1, -2)).float()
    idx = clamped_position_index(ws, table_ws, qkv.device)
    bias = table[idx.reshape(-1)].reshape(N, N, H)
    attn = attn + bias.permute(2, 0, 1)[None].float()
    if shift > 0:
        mask = cached_shift_mask(grid[0] * ws, grid[1] * ws, ws, shift, qkv.device)
        nW = mask.shape[0]
        attn = (attn.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
                ).reshape(Bn, H, N, N)
    attn = attn.softmax(-1).to(v.dtype)
    return torch.matmul(attn, v).transpose(1, 2).reshape(Bn, N, C)


def window_attention(qkv: torch.Tensor, table: torch.Tensor, num_heads: int, ws: int,
                     table_ws: int, shift: int, grid: Tuple[int, int], scale: float,
                     impl: Optional[str] = None) -> torch.Tensor:
    """K6 wrapper: the CUDA kernel for CUDA tensors, the twin for CPU
    tensors or ``impl="twin"`` (see ``_build.use_kernel``).  On a CUDA
    tensor it raises for what the kernel cannot take, inputs that need a
    gradient included (K6 has no backward); it never falls back.  Each
    launch counts one ``window_attn_kernel`` (``utils/tracing.py``)."""
    if not _build.use_kernel(qkv, impl, "window_attention"):
        return window_attention_twin(qkv, table, num_heads, ws, table_ws, shift, grid,
                                     scale)
    if torch.is_grad_enabled() and (qkv.requires_grad or table.requires_grad):
        raise ValueError("window_attention: the kernel has no backward, and its inputs "
                         "need a gradient; a train-mode forward runs the twin")
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    if (qkv.dtype != torch.bfloat16 or C != HEAD_DIM * num_heads or N != ws * ws
            or not 1 <= ws <= table_ws <= MAX_WINDOW or not 0 <= shift < ws
            or Bn % (grid[0] * grid[1])
            or tuple(table.shape) != ((2 * table_ws - 1) ** 2, num_heads)):
        raise ValueError(
            f"window_attention: the kernel takes bf16 qkv with head width {HEAD_DIM} and "
            f"windows up to {MAX_WINDOW}; got {qkv.dtype} {tuple(qkv.shape)}, "
            f"{num_heads} heads, window {ws} of {table_ws}, shift {shift}, grid {grid}, "
            f"table {tuple(table.shape)}")
    table = table.detach().float().contiguous()
    _build.check_inputs("window_attention", qkv, table)
    out = torch.empty((Bn, N, C), dtype=torch.bfloat16, device=qkv.device)
    _build.launch(window_attention, "pctrans_window_attn_fwd", qkv, table, out, Bn, ws, C,
                  num_heads, table_ws, grid[0], grid[1], shift, float(scale),
                  counter="window_attn_kernel")
    return out


window_attention.launches = 0
