"""Multi-scale deformable attention core: the plain twin, the K1 forward and
the K2 backward.

Replaces the TPU kernels ``pctrans_tpu/ops/msdeform_pallas2.py``
``_fused_kernel`` (K1) and ``_level_bwd_kernel`` (K2) with the CUDA kernels
``pctrans_torch/csrc/msdeform_fwd.cu`` (direct bilinear gather, one thread
per output element) and ``pctrans_torch/csrc/msdeform_bwd.cu`` (the same
thread map, scattering d_value with f32 atomics); their headers give the
bounds and the designs.  :class:`MSDeformAttnFunction` joins the two under
autograd, as ``ms_deform_attn_core_pallas2``'s custom VJP does.

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

Derivative convention (``msdeform_pallas2.py:138-144``): the bilinear
weights are hats ``relu(1 - |s - p|)`` whose location derivative is
``sign(s - p)`` on the open support, so a sample at an exactly integral
pixel coordinate gets zero location gradient along that axis.
``grid_sample``'s backward uses the floor difference ``v(x0+1) - v(x0)``
there instead; the twin and K2 both follow the JAX kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build


def ms_deform_attn_twin(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a 4-corner gather with hat weights per level,
    in f32.  Differentiable; its autograd is K2's plain version."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    with torch.autocast(value.device.type, enabled=False):
        v32 = value.float()
        loc = sampling_locations.float()
        out = v32.new_zeros((B, M, Lq * P, D))
        start = 0
        for lid, (H, W) in enumerate(spatial_shapes):
            v = v32[:, start:start + H * W].permute(0, 2, 1, 3)   # [B, M, HW, D]
            # [B, Lq, M, P] -> [B, M, Lq*P]
            x = (loc[:, :, :, lid, :, 0] * W - 0.5).permute(0, 2, 1, 3).reshape(B, M, -1)
            y = (loc[:, :, :, lid, :, 1] * H - 0.5).permute(0, 2, 1, 3).reshape(B, M, -1)
            w = attention_weights[:, :, :, lid].float().permute(0, 2, 1, 3).reshape(B, M, -1)
            x0, y0 = torch.floor(x).detach(), torch.floor(y).detach()
            for dy in (0, 1):
                cy = y0 + dy
                hy = torch.relu(1.0 - torch.abs(cy - y))
                for dx in (0, 1):
                    cx = x0 + dx
                    hx = torch.relu(1.0 - torch.abs(cx - x))
                    inside = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)  # NaN: False
                    idx = (cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1))
                    idx = torch.where(inside, idx, 0).long()
                    corner = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, D))
                    cw = torch.where(inside, hx * hy * w, 0.0)
                    out = out + cw[..., None] * corner
            start += H * W
    out = out.reshape(B, M, Lq, P, D).sum(3)                      # [B, M, Lq, D]
    return out.permute(0, 2, 1, 3).reshape(B, Lq, M * D).to(value.dtype)


def _shapes_arg(spatial_shapes):
    flat = [int(v) for hw in spatial_shapes for v in hw]
    return ctypes.cast((ctypes.c_int * len(flat))(*flat), ctypes.c_void_p)


def _check_shapes(op, value, spatial_shapes, sampling_locations):
    S = value.shape[1]
    L = sampling_locations.shape[3]
    if L != len(spatial_shapes) or S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"{op}: spatial_shapes do not match value")


def _check_kernel_inputs(op, value, *tensors):
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op}: value dtype {value.dtype}")
    _build.check_inputs(op, value, *tensors)


def _launch_forward(value, spatial_shapes, loc, w) -> torch.Tensor:
    """One K1 launch on contiguous CUDA tensors that need no grad."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    _check_kernel_inputs("ms_deform_attn", value, loc, w)
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    lib = _build.load_kernels()
    rc = lib.pctrans_msdeform_fwd(
        value.data_ptr(), loc.data_ptr(), w.data_ptr(), out.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes),
        int(value.dtype == torch.bfloat16), _build.stream_of(value))
    _build.check(lib, rc, "ms_deform_attn")
    ms_deform_attn.launches += 1
    return out


class MSDeformAttnFunction(torch.autograd.Function):
    """K1 forward, K2 backward (``ms_deform_attn_core_pallas2``'s VJP).
    Takes contiguous CUDA tensors with f32 locations and weights."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = tuple(spatial_shapes)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _launch_forward(value.detach(), ctx.spatial_shapes,
                               sampling_locations.detach(),
                               attention_weights.detach())

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, w = ctx.saved_tensors
        d_value, d_loc, d_w = ms_deform_attn_backward(
            value, ctx.spatial_shapes, loc, w, grad_out)
        return d_value, None, d_loc, d_w


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   impl: Optional[str] = None) -> torch.Tensor:
    """K1 (+ K2 under autograd) for CUDA tensors, the twin for CPU tensors
    or ``impl="twin"`` (see ``_build.use_kernel``)."""
    _check_shapes("ms_deform_attn", value, spatial_shapes, sampling_locations)
    if not _build.use_kernel(value, impl, "ms_deform_attn"):
        return ms_deform_attn_twin(value, spatial_shapes, sampling_locations,
                                   attention_weights)
    return MSDeformAttnFunction.apply(
        value.contiguous(), tuple(spatial_shapes),
        sampling_locations.float().contiguous(),
        attention_weights.float().contiguous())


ms_deform_attn.launches = 0


def ms_deform_attn_backward(value: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            grad_out: torch.Tensor,
                            impl: Optional[str] = None):
    """K2 wrapper: ``(d_value, d_locations, d_weights)`` of
    ``sum(ms_deform_attn(...) * grad_out)``, in the primals' dtypes.

    CUDA tensors launch the kernel (``d_value`` accumulates in f32 with
    atomics, so it is not bit-reproducible); CPU tensors or ``impl="twin"``
    take the twin's autograd.
    """
    _check_shapes("ms_deform_attn_backward", value, spatial_shapes,
                  sampling_locations)
    if not _build.use_kernel(value, impl, "ms_deform_attn_backward"):
        with torch.enable_grad():
            prim = [t.detach().requires_grad_() for t in
                    (value, sampling_locations, attention_weights)]
            out = ms_deform_attn_twin(prim[0], spatial_shapes, prim[1], prim[2])
            return torch.autograd.grad(out, prim, grad_out.to(out.dtype))
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if D > 32 or D & (D - 1):
        raise ValueError(f"ms_deform_attn_backward: the kernel reduces over a "
                         f"head's channels within a warp, D must be a power "
                         f"of two <= 32, got {D}")
    value = value.detach().contiguous()
    loc = sampling_locations.detach().float().contiguous()
    w = attention_weights.detach().float().contiguous()
    grad = grad_out.detach().to(value.dtype).contiguous()
    _check_kernel_inputs("ms_deform_attn_backward", value, loc, w, grad)
    d_value = torch.zeros((B, S, M, D), dtype=torch.float32, device=value.device)
    d_loc = torch.empty_like(loc)
    d_w = torch.empty_like(w)
    lib = _build.load_kernels()
    rc = lib.pctrans_msdeform_bwd(
        value.data_ptr(), loc.data_ptr(), w.data_ptr(), grad.data_ptr(),
        d_value.data_ptr(), d_loc.data_ptr(), d_w.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes),
        int(value.dtype == torch.bfloat16), _build.stream_of(value))
    _build.check(lib, rc, "ms_deform_attn_backward")
    ms_deform_attn_backward.launches += 1
    return (d_value.to(value.dtype), d_loc.to(sampling_locations.dtype),
            d_w.to(attention_weights.dtype))


ms_deform_attn_backward.launches = 0
