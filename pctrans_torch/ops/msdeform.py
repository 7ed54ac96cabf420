"""Multi-scale deformable attention core: the plain twin and the K1 wrapper.

Replaces the TPU kernel ``pctrans_tpu/ops/msdeform_pallas2.py:_fused_kernel``
with the CUDA kernel ``pctrans_torch/csrc/msdeform_fwd.cu`` (direct bilinear
gather, one thread per output element; its header gives the bound and the
design).  Forward only: the backward kernel (K2) comes with the train slice.

Op contract (``pctrans_tpu/ops/msdeform.py:1-18``): for every query, head
and level, bilinearly sample ``P`` points of the flattened value map and
blend them with the attention weights.  Sampling follows
``grid_sample(align_corners=False, padding_mode="zeros")`` on
``grid = 2*loc - 1``: pixel position ``loc * size - 0.5``, corners outside
the map contribute zero.

  value:              [B, S, M, D]          S = sum(H_l * W_l)
  sampling_locations: [B, Lq, M, L, P, 2]   f32, normalised (x, y)
  attention_weights:  [B, Lq, M, L, P]      f32
  returns:            [B, Lq, M * D]        in the value dtype
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build


def ms_deform_attn_twin(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``grid_sample`` per level in f32."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    with torch.autocast(value.device.type, enabled=False):
        v32 = value.float()
        grids = 2.0 * sampling_locations.float() - 1.0
        out = value.new_zeros((B * M, D, Lq), dtype=torch.float32)
        start = 0
        for lid, (H, W) in enumerate(spatial_shapes):
            v = v32[:, start:start + H * W]                      # [B, HW, M, D]
            v = v.permute(0, 2, 3, 1).reshape(B * M, D, H, W)
            g = grids[:, :, :, lid].permute(0, 2, 1, 3, 4).reshape(B * M, Lq, P, 2)
            sampled = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                    align_corners=False)          # [BM, D, Lq, P]
            w = attention_weights[:, :, :, lid].float()          # [B, Lq, M, P]
            w = w.permute(0, 2, 1, 3).reshape(B * M, 1, Lq, P)
            out = out + (sampled * w).sum(-1)
            start += H * W
    out = out.reshape(B, M, D, Lq).permute(0, 3, 1, 2).reshape(B, Lq, M * D)
    return out.to(value.dtype)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   impl: Optional[str] = None) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the twin for CPU
    tensors or ``impl="twin"`` (see ``_build.use_kernel``)."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes) or S != sum(h * w for h, w in spatial_shapes):
        raise ValueError("ms_deform_attn: spatial_shapes do not match value")
    if not _build.use_kernel(value, impl, "ms_deform_attn"):
        return ms_deform_attn_twin(value, spatial_shapes, sampling_locations,
                                   attention_weights)
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ms_deform_attn: value dtype {value.dtype}")
    value = value.contiguous()
    loc = sampling_locations.float().contiguous()
    w = attention_weights.float().contiguous()
    _build.check_inputs("ms_deform_attn", value, loc, w)
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[int(v) for hw in spatial_shapes
                                         for v in hw])
    lib = _build.load_kernels()
    rc = lib.pctrans_msdeform_fwd(
        value.data_ptr(), loc.data_ptr(), w.data_ptr(), out.data_ptr(),
        B, S, M, D, Lq, L, P, ctypes.cast(shapes, ctypes.c_void_p),
        int(value.dtype == torch.bfloat16), _build.stream_of(value))
    _build.check(lib, rc, "ms_deform_attn")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
