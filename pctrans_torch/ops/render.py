"""CondInst dynamic mask render: the plain twin and the K3 wrapper.

Replaces the TPU kernel ``pctrans_tpu/ops/render_pallas.py:_render_kernel``
with the CUDA kernel ``pctrans_torch/csrc/render.cu`` (one thread per
(b, q, pixel), weights in shared memory, MLP in registers; its header gives
the bound and the design).  Forward only: training renders with the twin.

Per query q a 3-layer 1x1-conv MLP (ch = 8) with controller-generated
weights runs over ``[inst_xy(q) - loc(pixel), feats(pixel)]`` at every
stride-``s`` pixel (``render_pallas.py:1-11``):

  feats: [B, HW, Cm]; inst_xy: [B, Q, 2] f32 pixel coords;
  w1: [B, Q, ch, cin] (cin = 2 + Cm with rel coords, rel rows first);
  w2: [B, Q, ch, ch]; w3: [B, Q, 1, ch]; b1/b2: [B, Q, ch]; b3: [B, Q, 1]
  returns [B, Q, HW] f32
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

CH = 8  # the kernel's compile-time dynamic_mask_channels


def render_twin(feats, inst_xy, w1, w2, w3, b1, b2, b3,
                hw: Tuple[int, int], stride: int,
                rel_coord: bool = True) -> torch.Tensor:
    """Plain PyTorch version: ``render_reference`` (``render_pallas.py:60-93``)
    in f32."""
    Hm, Wm = hw
    with torch.autocast(feats.device.type, enabled=False):
        feats = feats.float()
        x = torch.einsum("bso,bqco->bqcs", feats,
                         w1[..., 2:].float() if rel_coord else w1.float())
        if rel_coord:
            dev = feats.device
            xs = torch.arange(Wm, dtype=torch.float32, device=dev) * stride + stride // 2
            ys = torch.arange(Hm, dtype=torch.float32, device=dev) * stride + stride // 2
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            locations = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
            rel = inst_xy.float()[:, :, None, :] - locations[None, None]  # [B,Q,HW,2]
            x = x + torch.einsum("bqso,bqco->bqcs", rel, w1[..., :2].float())
        x = torch.relu(x + b1.float()[..., None])
        x = torch.relu(torch.einsum("bqos,bqco->bqcs", x, w2.float())
                       + b2.float()[..., None])
        x = torch.einsum("bqos,bqco->bqcs", x, w3.float()) + b3.float()[..., None]
    return x[:, :, 0, :]


def dynamic_mask_render(feats, inst_xy, w1, w2, w3, b1, b2, b3,
                        hw: Tuple[int, int], stride: int,
                        rel_coord: bool = True,
                        impl: Optional[str] = None) -> torch.Tensor:
    """K3 wrapper: the CUDA kernel for CUDA tensors, the twin for CPU
    tensors or ``impl="twin"`` (see ``_build.use_kernel``)."""
    B, HW, Cm = feats.shape
    Q, ch, cin = w1.shape[1:]
    Hm, Wm = hw
    if HW != Hm * Wm or cin != Cm + (2 if rel_coord else 0):
        raise ValueError("dynamic_mask_render: inconsistent shapes")
    if not _build.use_kernel(feats, impl, "dynamic_mask_render"):
        return render_twin(feats, inst_xy, w1, w2, w3, b1, b2, b3, hw, stride,
                           rel_coord)
    if ch != CH or Cm % 4:
        raise ValueError(f"dynamic_mask_render: kernel needs ch == {CH} and "
                         f"Cm % 4 == 0 (float4 loads), got ch {ch}, Cm {Cm}")
    args = [t.float().contiguous() for t in (feats, inst_xy, w1, w2, w3, b1, b2, b3)]
    if args[0].data_ptr() % 16:         # a view at an offset: float4 needs 16 B
        args[0] = args[0].clone()
    _build.check_inputs("dynamic_mask_render", *args)
    out = torch.empty((B, Q, HW), dtype=torch.float32, device=feats.device)
    lib = _build.load_kernels()
    rc = lib.pctrans_render_fwd(*[t.data_ptr() for t in args], out.data_ptr(),
                                B, Q, Hm, Wm, Cm, int(rel_coord), int(stride),
                                _build.stream_of(feats))
    _build.check(lib, rc, "dynamic_mask_render")
    dynamic_mask_render.launches += 1
    return out


dynamic_mask_render.launches = 0
