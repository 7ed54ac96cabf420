"""Multi-scale deformable attention core: the plain twins, the K1 and K5
forwards and the K2 backward.

Replaces the TPU kernels ``pctrans_tpu/ops/msdeform_pallas2.py``
``_fused_kernel`` (K1) and ``_level_bwd_kernel`` (K2) with the CUDA kernels
``pctrans_torch/csrc/msdeform_fwd.cu`` (direct bilinear gather, one thread
per 16-byte channel group of a head, loc and w staged by cp.async) and
``pctrans_torch/csrc/msdeform_bwd.cu`` (one thread per 4 channels of a
head, loc and w staged by cp.async, d_value scattered with 4-channel f32
vector reductions), and
``pctrans_tpu/ops/msdeform_pallas.py`` ``_level_kernel`` (K5) with
``pctrans_torch/csrc/msdeform_separable.cu`` (the two-stage separable
contraction, stage 1 as bf16 or 3xTF32 tensor-core products over 16-query
tiles, tiles of zero hats skipped, the value map staged in shared memory in
passes that :func:`separable_plan` lays out); their headers give the
bounds and the designs.  K5 and its twin round ``hat_x`` to the value
dtype before stage 1, as the JAX kernel does (``ROADMAP.md`` §C.10).
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
    axis, stage 2 ``sum_h hat_y * w * t``.  ``hat_x`` is rounded to the
    value dtype before stage 1, as the JAX kernel's ``hx.astype(v.dtype)``
    (``msdeform_pallas.py:101``) and the XLA separable form do; the
    products, ``hat_y * w`` and every sum stay in f32 (for f32 values the
    rounding is the identity).  Differentiable; the rounding passes the
    gradient through unchanged (``ROADMAP.md`` §C.10)."""
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
                hx = hx.to(value.dtype).float()      # JAX's hx.astype(v.dtype)
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


# shared memory an H100 block may take, less K5's static tile counter
SEPARABLE_SMEM_BYTES = 232_448 - 16
SEPARABLE_MAX_PASSES = 16
SEPARABLE_MAX_SEGMENTS = 32


def separable_row_stride(W: int, element_size: int) -> int:
    """Elements of one staged (h, d) row of K5's slab: W rounded up to whole
    16-column K tiles, plus 8 bf16 or 4 f32 (4 words: the fragment reads of
    a warp then hit 32 banks)."""
    return 16 * -(-W // 16) + (8 if element_size == 2 else 4)


def separable_plan(spatial_shapes: Sequence[Tuple[int, int]], D: int,
                   element_size: int, budget: int = SEPARABLE_SMEM_BYTES):
    """K5's passes over the value map (``msdeform_separable.cu``): a list of
    passes, each a list of segments ``(level, h0, h1, offset)`` that stage
    rows ``[h0, h1)`` of a level at element ``offset`` of the shared slab.
    Rows fill each pass in level order up to ``budget`` bytes; a level that
    does not fit the rest of a pass is split there.  Raises ``ValueError``
    when one row does not fit or the plan outgrows the kernel's tables."""
    passes, segs, used = [], [], 0
    for lid, (H, W) in enumerate(spatial_shapes):
        row = D * separable_row_stride(W, element_size) * element_size
        if row > budget:
            raise ValueError(f"ms_deform_attn_separable: one staged row of level "
                             f"{lid} (W = {W}, D = {D}) takes {row} bytes of shared "
                             f"memory, more than the kernel's {budget}")
        h = 0
        while h < H:
            take = min((budget - used) // row, H - h)
            if take == 0:
                passes.append(segs)
                segs, used = [], 0
                continue
            segs.append((lid, h, h + take, used // element_size))
            used += take * row
            h += take
    passes.append(segs)
    if (len(passes) > SEPARABLE_MAX_PASSES
            or sum(map(len, passes)) > SEPARABLE_MAX_SEGMENTS):
        raise ValueError(f"ms_deform_attn_separable: the value map needs {len(passes)} "
                         f"passes of {sum(map(len, passes))} row bands, more than the "
                         f"kernel's {SEPARABLE_MAX_PASSES} and {SEPARABLE_MAX_SEGMENTS}")
    return passes


def _check_separable_layout(value, spatial_shapes, loc, w):
    """What K5 takes (``msdeform_separable.cu``): D in whole n8 tensor-core
    tiles (8, 16 or 32), 16-byte aligned tensors, a value map that
    :func:`separable_plan` can stage.  Returns the plan."""
    D = value.shape[3]
    if D not in (8, 16, 32):
        raise ValueError(f"ms_deform_attn_separable: the kernel's products take a "
                         f"head's channels in n8 tiles, D must be 8, 16 or 32, got {D}")
    if any(t.data_ptr() % 16 for t in (value, loc, w)):
        raise ValueError("ms_deform_attn_separable: the kernel needs 16-byte aligned "
                         "value, locations and weights")
    return separable_plan(spatial_shapes, D, value.element_size())


def _launch_separable(value, spatial_shapes, loc, w) -> torch.Tensor:
    """One K5 launch on contiguous CUDA tensors that need no grad."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    _check_kernel_inputs("ms_deform_attn_separable", value, loc, w)
    passes = _check_separable_layout(value, spatial_shapes, loc, w)
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    part = None
    if len(passes) > 1 and value.dtype == torch.bfloat16:
        part = torch.empty((B, Lq, M * D), dtype=torch.float32, device=value.device)
    first = [0]
    for segs in passes:
        first.append(first[-1] + len(segs))
    flat = [len(passes), *first, *(v for segs in passes for seg in segs for v in seg)]
    plan = ctypes.cast((ctypes.c_int * len(flat))(*flat), ctypes.c_void_p)
    smem = max(sum((h1 - h0) * D * separable_row_stride(spatial_shapes[lid][1],
                                                         value.element_size())
                   for lid, h0, h1, _ in segs) for segs in passes) * value.element_size()
    lib = _build.load_kernels()
    rc = lib.pctrans_msdeform_sep_fwd(
        value.data_ptr(), loc.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes), plan, smem,
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


AGGREGATE_SAMPLES_PER_POSITION = 32


def backward_aggregated_levels(spatial_shapes: Sequence[Tuple[int, int]],
                               Lq: int, P: int) -> int:
    """K2's plan: bit ``l`` set when level ``l``'s d_value reductions are
    first summed over the lanes of a warp that hit the same corner
    (``msdeform_bwd.cu``), which pays where neighbouring queries collide.
    That is the levels whose queries put at least
    ``AGGREGATE_SAMPLES_PER_POSITION`` samples on each position on average
    (``Lq * P / (H * W)`` per batch and head): at the CVPPP train shape the
    14x14 level takes 84 (faster on the model's own inputs), the 28x28 level
    21 (slower)."""
    return sum(1 << lid for lid, (H, W) in enumerate(spatial_shapes)
               if Lq * P >= AGGREGATE_SAMPLES_PER_POSITION * H * W)


def _check_backward_layout(value, loc, w) -> None:
    """What K2 takes (``msdeform_bwd.cu``): 4 channels per thread, a head's
    D / 4 threads a power of two <= 32 (they sum within a warp), 16-byte
    aligned tensors, 32-bit offsets inside one image."""
    B, S, M, D = value.shape
    lanes = D // 4
    if D % 4 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"ms_deform_attn_backward: a kernel thread takes 4 "
                         f"channels and a head's D / 4 threads sum within a warp; "
                         f"D must be 4 times a power of two <= 32, got {D}")
    if any(t.data_ptr() % 16 for t in (value, loc, w)):
        raise ValueError("ms_deform_attn_backward: the kernel needs 16-byte "
                         "aligned value, locations and weights")
    if S * M * D >= 2 ** 31:
        raise ValueError("ms_deform_attn_backward: the kernel's offsets are 32-bit")


def ms_deform_attn_backward(value: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            grad_out: torch.Tensor,
                            impl: Optional[str] = None):
    """K2 wrapper: ``(d_value, d_locations, d_weights)`` of
    ``sum(ms_deform_attn(...) * grad_out)``, in the primals' dtypes.

    CUDA tensors launch the kernel: ``d_value`` accumulates in f32 with
    vector reductions in global memory, in no fixed order,
    so it is not deterministic (run to run it differs by f32 rounding);
    ``d_locations`` and ``d_weights`` have one writer each.  CPU tensors or
    ``impl="twin"`` take the twin's autograd.
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
    value = value.detach().contiguous()
    loc = sampling_locations.detach().float().contiguous()
    w = attention_weights.detach().float().contiguous()
    grad = grad_out.detach().to(value.dtype).contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()         # the kernel reads it in aligned groups
    _check_kernel_inputs("ms_deform_attn_backward", value, loc, w, grad)
    _check_backward_layout(value, loc, w)
    d_value = torch.zeros((B, S, M, D), dtype=torch.float32, device=value.device)
    d_loc = torch.empty_like(loc)
    d_w = torch.empty_like(w)
    lib = _build.load_kernels()
    rc = lib.pctrans_msdeform_bwd(
        value.data_ptr(), loc.data_ptr(), w.data_ptr(), grad.data_ptr(),
        d_value.data_ptr(), d_loc.data_ptr(), d_w.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes),
        backward_aggregated_levels(spatial_shapes, Lq, P),
        int(value.dtype == torch.bfloat16), _build.stream_of(value))
    _build.check(lib, rc, "ms_deform_attn_backward")
    ms_deform_attn_backward.launches += 1
    return (d_value.to(value.dtype), d_loc.to(sampling_locations.dtype),
            d_w.to(attention_weights.dtype))


ms_deform_attn_backward.launches = 0
