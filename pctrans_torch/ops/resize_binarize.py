"""Fused bilinear upsample + threshold binarize: the plain twin and the K4
wrapper.

Replaces the TPU kernel ``pctrans_tpu/ops/resize_pallas.py:_kernel`` with
the CUDA kernel ``pctrans_torch/csrc/resize_binarize.cu`` (one thread per 4
output columns of a tile of ``TILE_ROWS`` rows: each W-interpolated source
row formed once and kept in registers while the rows that tap it pass, 4
output bytes per store; its header gives the bound and the design).  ``[B, Q, h, w]`` f32 logits -> ``[B, Q, H, W]`` u8
``(resize_bilinear(x) > logit_t)``; the full-resolution logits are never
stored.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .resize import resize_bilinear


def resize_binarize_twin(x: torch.Tensor, size: Tuple[int, int],
                         logit_t: float) -> torch.Tensor:
    """Plain PyTorch version: f32 resize, then compare."""
    return (resize_bilinear(x.float(), size) > logit_t).to(torch.uint8)


def interp_table(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Two taps per output index: (index [out, 2] int32, weight [out, 2] f32).

    ``jax.image.resize``'s half-pixel rule: output i samples input
    coordinate ``(i + 0.5) * in/out - 0.5`` with the width-1 triangle kernel;
    taps off the edge are dropped and the rest renormalised.  Dense, the
    table is ``pctrans_tpu.ops.resize_pallas.resize_weights(in, out)``.
    """
    s = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    i0 = np.floor(s)
    frac = s - i0
    taps = np.stack([i0, i0 + 1], 1).astype(np.int64)
    w = np.stack([1.0 - frac, frac], 1)
    w = np.where((taps >= 0) & (taps < in_size), w, 0.0)
    w = w / w.sum(1, keepdims=True)
    return np.clip(taps, 0, in_size - 1).astype(np.int32), w.astype(np.float32)


TILE_ROWS = 32     # output rows per K4 thread: it keeps the last two
                   # W-interpolated source rows in registers across them


@functools.lru_cache(maxsize=32)
def _device_table(in_size: int, out_size: int, device: torch.device):
    """:func:`interp_table` on the card, built once per shape: a host-to-device
    copy on every call would stall the stream."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in interp_table(in_size, out_size))


def resize_bilinear_binarize(x: torch.Tensor, size: Tuple[int, int],
                             logit_t: float,
                             impl: Optional[str] = None) -> torch.Tensor:
    """K4 wrapper: the CUDA kernel for CUDA tensors, the twin for CPU
    tensors or ``impl="twin"`` (see ``_build.use_kernel``)."""
    if not _build.use_kernel(x, impl, "resize_bilinear_binarize"):
        return resize_binarize_twin(x, size, logit_t)
    B, Q, h, w = x.shape
    H, W = size
    x = x.float().contiguous()
    dev = x.device
    row_idx, row_w = _device_table(h, H, dev)
    col_idx, col_w = _device_table(w, W, dev)
    _build.check_inputs("resize_bilinear_binarize", x, row_idx, row_w,
                        col_idx, col_w)
    out = torch.empty((B, Q, H, W), dtype=torch.uint8, device=dev)
    lib = _build.load_kernels()
    rc = lib.pctrans_resize_binarize(
        x.data_ptr(), row_idx.data_ptr(), row_w.data_ptr(), col_idx.data_ptr(),
        col_w.data_ptr(), out.data_ptr(), B * Q, h, w, H, W, TILE_ROWS,
        float(logit_t),
        _build.stream_of(x))
    _build.check(lib, rc, "resize_bilinear_binarize")
    resize_bilinear_binarize.launches += 1
    return out


resize_bilinear_binarize.launches = 0
