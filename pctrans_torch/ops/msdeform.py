"""Multi-scale deformable attention core: the plain twins, the K1 and K5
forwards and the K2 backward.

Replaces the TPU kernels ``pctrans_tpu/ops/msdeform_pallas2.py``
``_fused_kernel`` (K1) and ``_level_bwd_kernel`` (K2) with the CUDA kernels
``pctrans_torch/csrc/msdeform_fwd.cu`` (direct bilinear gather, one thread
per 16-byte channel group of a head, loc and w staged by cp.async) and
``pctrans_torch/csrc/msdeform_bwd.cu`` (one thread per channel, scattering
d_value with f32 atomics), and
``pctrans_tpu/ops/msdeform_pallas.py`` ``_level_kernel`` (K5) with
``pctrans_torch/csrc/msdeform_separable.cu`` (the dense two-stage separable
contraction); their headers give the bounds and the designs.
:class:`MSDeformAttnFunction` joins K1 and K2 under autograd, as
``ms_deform_attn_core_pallas2``'s custom VJP does;
:class:`MSDeformAttnSeparableFunction` joins K5 and K2 (the JAX package
differentiates K5 through XLA, which the card must not run on the path).

Selection (``pctrans_tpu/ops/msdeform.py:66-82``): :func:`ms_deform_attn`
with ``impl=None`` reads ``$PCTRANS_MSDA_IMPL`` at every call: unset,
``auto`` or ``pallas2`` take K1, ``pallas`` takes K5.  An explicit ``impl``
(``"twin"``, ``"pallas"``, ``"pallas2"``) wins over the variable.  On the
CPU ``pallas`` runs the separable twin and the default the 4-corner twin.

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
there instead; the twins and K2 all follow the JAX kernel.  The JAX
package's K5 differs there: its VJP differentiates the XLA separable form,
where ``jax.grad(jnp.abs)(0.) == 1``, so at an integral coordinate it gives
``-V[s0]``-type values (``ROADMAP.md`` §C.7); the port's K5 path takes K2's
zero.
"""

from __future__ import annotations

import ctypes
import os
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


SEPARABLE_CHUNK = 128     # queries per stage-1 product, as the JAX K5's chunk


def ms_deform_attn_separable_twin(value: torch.Tensor,
                                  spatial_shapes: Sequence[Tuple[int, int]],
                                  sampling_locations: torch.Tensor,
                                  attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5 (``ms_deform_attn_core_separable``,
    ``pctrans_tpu/ops/msdeform.py:193-270``): per level and chunk of
    ``SEPARABLE_CHUNK`` queries, stage 1 ``t = hat_x @ V^T`` over the W
    axis, stage 2 ``sum_h hat_y * w * t``.  Hats and sums in f32;
    differentiable."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    with torch.autocast(value.device.type, enabled=False):
        v32 = value.float()
        loc = sampling_locations.float().permute(0, 2, 1, 3, 4, 5)  # [B, M, Lq, L, P, 2]
        attw = attention_weights.float().permute(0, 2, 1, 3, 4)    # [B, M, Lq, L, P]
        out = v32.new_zeros((B, M, Lq, D))
        start = 0
        for lid, (H, W) in enumerate(spatial_shapes):
            # stage-1 right-hand side [B, M, W, H*D]
            vT = v32[:, start:start + H * W].reshape(B, H, W, M, D)
            vT = vT.permute(0, 3, 2, 1, 4).reshape(B, M, W, H * D)
            sx = torch.arange(W, dtype=torch.float32, device=value.device)
            sy = torch.arange(H, dtype=torch.float32, device=value.device)
            chunks = []
            for q0 in range(0, Lq, SEPARABLE_CHUNK):
                q = slice(q0, q0 + SEPARABLE_CHUNK)
                x = loc[:, :, q, lid, :, 0] * W - 0.5                 # [B, M, c, P]
                y = loc[:, :, q, lid, :, 1] * H - 0.5
                c = x.shape[2]
                hx = torch.relu(1.0 - torch.abs(x[..., None] - sx))  # [B, M, c, P, W]
                t = torch.matmul(hx.reshape(B, M, c * P, W), vT)
                t = t.reshape(B, M, c, P, H, D)
                hy = torch.relu(1.0 - torch.abs(y[..., None] - sy))
                hy = hy * attw[:, :, q, lid, :, None]                # [B, M, c, P, H]
                chunks.append(torch.einsum("bmcph,bmcphd->bmcd", hy, t))
            out = out + torch.cat(chunks, dim=2)
            start += H * W
    return out.permute(0, 2, 1, 3).reshape(B, Lq, M * D).to(value.dtype)


# TPU formulations the port does not carry (ROADMAP.md, "Not to port")
_NOT_PORTED = ("matmul", "separable", "gather", "reference")


def resolve_impl(impl: Optional[str]) -> str:
    """The formulation :func:`ms_deform_attn` runs: ``"pallas2"`` (K1),
    ``"pallas"`` (K5) or ``"twin"`` (the 4-corner twin on any device).
    ``impl=None`` reads ``$PCTRANS_MSDA_IMPL`` now; the variable selects a
    kernel only, never a twin."""
    if impl in ("twin", "pallas", "pallas2"):
        return impl
    if impl is not None:
        source, name = "impl", impl
    else:
        name = os.environ.get("PCTRANS_MSDA_IMPL") or "auto"
        if name in ("auto", "pallas2"):
            return "pallas2"
        if name == "pallas":
            return "pallas"
        source = "$PCTRANS_MSDA_IMPL"
    if name in _NOT_PORTED:
        raise ValueError(
            f"ms_deform_attn: {source}={name!r} is a TPU formulation on "
            "ROADMAP.md's 'Not to port' list; the port has pallas2 (K1) and "
            "pallas (K5)")
    allowed = ("None, 'twin', 'pallas' or 'pallas2'" if source == "impl"
               else "unset, 'auto', 'pallas2' or 'pallas'")
    raise ValueError(f"ms_deform_attn: {source} must be {allowed}, got {name!r}")


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


def _check_forward_layout(value, loc, w) -> None:
    """What K1 takes (``msdeform_fwd.cu``): a head's channels in whole
    16-byte groups (8 bf16 or 4 f32), at most 64 such groups per query,
    16-byte aligned tensors, 32-bit offsets inside one image."""
    B, S, M, D = value.shape
    per_load = 16 // value.element_size()
    if D % per_load or M * D // per_load > 64:
        raise ValueError(f"ms_deform_attn: the kernel loads {per_load} channels "
                         f"of {value.dtype} per 16-byte access and runs at most "
                         f"64 threads per query; D must be a multiple of "
                         f"{per_load} and M * D <= {64 * per_load}, got M {M}, D {D}")
    if any(t.data_ptr() % 16 for t in (value, loc, w)):
        raise ValueError("ms_deform_attn: the kernel needs 16-byte aligned value, "
                         "locations and weights")
    if S * M * D >= 2 ** 31 or B * loc.shape[1] * M * D >= 2 ** 31:
        raise ValueError("ms_deform_attn: the kernel's offsets are 32-bit")


def _launch_forward(value, spatial_shapes, loc, w) -> torch.Tensor:
    """One K1 launch on contiguous CUDA tensors that need no grad."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    _check_kernel_inputs("ms_deform_attn", value, loc, w)
    _check_forward_layout(value, loc, w)
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    lib = _build.load_kernels()
    rc = lib.pctrans_msdeform_fwd(
        value.data_ptr(), loc.data_ptr(), w.data_ptr(), out.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes),
        int(value.dtype == torch.bfloat16), _build.stream_of(value))
    _build.check(lib, rc, "ms_deform_attn")
    ms_deform_attn.launches += 1
    return out


def _launch_separable(value, spatial_shapes, loc, w) -> torch.Tensor:
    """One K5 launch on contiguous CUDA tensors that need no grad."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    _check_kernel_inputs("ms_deform_attn_separable", value, loc, w)
    if D not in (4, 8, 16, 32):
        raise ValueError(f"ms_deform_attn_separable: the kernel keeps a head's "
                         f"channels in registers as float4, D must be 4, 8, "
                         f"16 or 32, got {D}")
    widest = max(W for _, W in spatial_shapes)
    if widest * D > 8192:
        raise ValueError(f"ms_deform_attn_separable: a staged value row of "
                         f"W*D = {widest * D} floats exceeds the kernel's 8192")
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    lib = _build.load_kernels()
    rc = lib.pctrans_msdeform_sep_fwd(
        value.data_ptr(), loc.data_ptr(), w.data_ptr(), out.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes),
        int(value.dtype == torch.bfloat16), _build.stream_of(value))
    _build.check(lib, rc, "ms_deform_attn_separable")
    ms_deform_attn_separable.launches += 1
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


class MSDeformAttnSeparableFunction(MSDeformAttnFunction):
    """K5 forward, K2 backward: K2 is the VJP of the same contract."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = tuple(spatial_shapes)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _launch_separable(value.detach(), ctx.spatial_shapes,
                                 sampling_locations.detach(),
                                 attention_weights.detach())


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   impl: Optional[str] = None) -> torch.Tensor:
    """The formulation :func:`resolve_impl` picks: K1 (+ K2 under autograd)
    or, for ``pallas``, :func:`ms_deform_attn_separable`.  A CPU tensor
    takes the formulation's twin; ``impl="twin"`` the 4-corner twin on any
    device (see ``_build.use_kernel``)."""
    _check_shapes("ms_deform_attn", value, spatial_shapes, sampling_locations)
    impl = resolve_impl(impl)
    if impl == "pallas":
        return ms_deform_attn_separable(value, spatial_shapes, sampling_locations,
                                        attention_weights)
    if impl == "twin" or not _build.use_kernel(value, None, "ms_deform_attn"):
        return ms_deform_attn_twin(value, spatial_shapes, sampling_locations,
                                   attention_weights)
    return MSDeformAttnFunction.apply(
        value.contiguous(), tuple(spatial_shapes),
        sampling_locations.float().contiguous(),
        attention_weights.float().contiguous())


ms_deform_attn.launches = 0


def ms_deform_attn_separable(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor) -> torch.Tensor:
    """K5 (+ K2 under autograd) for CUDA tensors, the separable twin for CPU
    tensors."""
    _check_shapes("ms_deform_attn_separable", value, spatial_shapes,
                  sampling_locations)
    if not _build.use_kernel(value, None, "ms_deform_attn_separable"):
        return ms_deform_attn_separable_twin(value, spatial_shapes,
                                             sampling_locations, attention_weights)
    return MSDeformAttnSeparableFunction.apply(
        value.contiguous(), tuple(spatial_shapes),
        sampling_locations.float().contiguous(),
        attention_weights.float().contiguous())


ms_deform_attn_separable.launches = 0


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
