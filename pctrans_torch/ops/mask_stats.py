"""The binarized masks' statistics: the plain twin and the K7 wrapper.

K7 (``pctrans_torch/csrc/mask_stats.cu``) replaces no Pallas kernel: the
JAX package leaves this product to XLA
(``pctrans_tpu/inference/device_postprocess.py:62-69``, ``_binary_dot``).
It reads the u8 [B, K, H, W] masks once (TMA), multiplies them on the
tensor cores (wgmma, u8 with i32 sums), and writes the packed f32 statistics
[B, K, K+1(+1)]: ``[..., :K]`` the intersections, ``[..., K]`` the areas
(the product's diagonal: m . m = sum m for 0/1 masks), ``[..., K+1]`` the
optional per-mask ``extra`` (its header gives the bound and the design).
Every count is an exact integer, as the twin's f32 sums of 0/1 products
are below 2^24, so the two are bit-equal.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build

TILE = 128          # masks per tile: a K7 block takes one tile pair I <= J
STAGE_PX = 128      # pixels per stage of K7's shared-memory ring (one swizzled row)
BLOCKS_PER_SM = 2   # blocks the pixel chunks aim for on each SM: one wave of K7


def mask_stats_twin(masks: torch.Tensor):
    """Plain PyTorch version: [B, K, H, W] binary (any dtype) -> (areas
    [B, K] i32, inter [B, K, K] i32) by one f32 ``bmm`` of the 0/1
    masks."""
    flat = masks.reshape(masks.shape[0], masks.shape[1], -1)
    f = flat.float()
    inter = torch.bmm(f, f.transpose(1, 2)).int()
    areas = flat.sum(dim=-1, dtype=torch.int32)
    return areas, inter


def packed_mask_stats_twin(masks: torch.Tensor,
                           extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`packed_mask_stats`."""
    areas, inter = mask_stats_twin(masks)
    cols = [inter.float(), areas[:, :, None].float()]
    if extra is not None:
        cols.append(extra[:, :, None].float())
    return torch.cat(cols, dim=-1)


class Plan(NamedTuple):
    tiles: int              # ceil(K / TILE)
    chunks: int             # pixel chunks per image and tile pair
    stages_per_chunk: int   # STAGE_PX-pixel stages in each chunk


def plan(B: int, K: int, P: int, sms: int) -> Plan:
    """K7's grid from the shapes it is given: the pixels of each image cut
    into chunks so that the grid (tile pairs, chunks, images) puts about
    ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs."""
    tiles = -(-K // TILE)
    pairs = tiles * (tiles + 1) // 2
    stages = max(1, -(-P // STAGE_PX))
    chunks = max(1, min(stages, -(-BLOCKS_PER_SM * sms // max(1, B * pairs))))
    per_chunk = -(-stages // chunks)
    return Plan(tiles, -(-stages // per_chunk), per_chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def packed_mask_stats(masks: torch.Tensor, extra: Optional[torch.Tensor] = None,
                      impl: Optional[str] = None) -> torch.Tensor:
    """K7 wrapper: [B, K, H, W] 0/1 masks (and ``extra`` [B, K]) -> the
    packed f32 statistics [B, K, K+1(+1)], one host fetch for all of them.
    The CUDA kernel for CUDA tensors, the twin for CPU tensors or
    ``impl="twin"`` (see ``_build.use_kernel``).  On a CUDA tensor it
    raises for anything but contiguous 4-D u8 masks; it never falls back.
    Each launch counts one ``mask_stats_kernel`` (``utils/tracing.py``)."""
    if not _build.use_kernel(masks, impl, "packed_mask_stats"):
        return packed_mask_stats_twin(masks, extra)
    if masks.dim() != 4 or masks.dtype != torch.uint8 or not masks.is_contiguous():
        raise ValueError("packed_mask_stats: the kernel takes contiguous [B, K, H, W] u8 "
                         f"masks; got {masks.dtype} {tuple(masks.shape)}"
                         + ("" if masks.is_contiguous() else ", not contiguous"))
    B, K, H, W = masks.shape
    if extra is not None:
        if tuple(extra.shape) != (B, K):
            raise ValueError(f"packed_mask_stats: extra {tuple(extra.shape)} is not "
                             f"[B, K] = {(B, K)}")
        extra = extra.detach().float().contiguous()
    _build.check_inputs("packed_mask_stats", masks,
                        *(() if extra is None else (extra,)))
    dev = masks.device
    ws = torch.empty((B, K, K), dtype=torch.int32, device=dev)
    out = torch.empty((B, K, K + 1 + (extra is not None)), dtype=torch.float32, device=dev)
    p = plan(B, K, H * W, _sm_count(dev))
    _build.launch(packed_mask_stats, "pctrans_mask_stats", masks, extra, ws, out, B, K,
                  H * W, p.tiles, p.chunks, p.stages_per_chunk, counter="mask_stats_kernel")
    return out


packed_mask_stats.launches = 0

