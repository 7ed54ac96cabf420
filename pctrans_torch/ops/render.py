"""CondInst dynamic mask render: the plain twin and the K3 wrapper.

Replaces the TPU kernel ``pctrans_tpu/ops/render_pallas.py:_render_kernel``
with the CUDA kernel ``pctrans_torch/csrc/render.cu`` (the queries' weights
rewritten once as mma fragment records, then a block per (b, 256 pixels)
looping over the queries, stages 1 and 2 as 3xTF32 ``mma.sync`` products to
f32 accuracy; its header gives the bound and the design).
Forward only: training renders with the twin in the compute dtype.

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
MAX_CM = 16  # feature columns the kernel's A fragments hold (two k-steps)


def render_twin(feats, inst_xy, w1, w2, w3, b1, b2, b3,
                hw: Tuple[int, int], stride: int,
                rel_coord: bool = True,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: ``render_reference`` (``render_pallas.py:60-93``)
    with its casts.  The rel-coord term runs in f32; the feature product,
    stage 1's sum (rel + features + b1), stages 2 and 3 and their biases in
    ``dtype``; the result is f32.  The default f32 is K3's arithmetic; the
    train graph passes the compute dtype, as the JAX train graph does
    (``transformer_decoder.py:436-443``)."""
    Hm, Wm = hw
    with torch.autocast(feats.device.type, enabled=False):
        x = torch.einsum("bso,bqco->bqcs", feats.to(dtype),
                         (w1[..., 2:] if rel_coord else w1).to(dtype))
        if rel_coord:
            dev = feats.device
            xs = torch.arange(Wm, dtype=torch.float32, device=dev) * stride + stride // 2
            ys = torch.arange(Hm, dtype=torch.float32, device=dev) * stride + stride // 2
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            locations = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
            rel = inst_xy.float()[:, :, None, :] - locations[None, None]  # [B,Q,HW,2]
            x = torch.einsum("bqso,bqco->bqcs", rel, w1[..., :2].float()) + x
        # JAX's promotion: an f32 term or bias keeps the sum in f32 until
        # the cast; bf16 + bf16 rounds to bf16 on the add
        x = torch.relu((x + b1[..., None]).to(dtype))
        x = torch.relu(torch.einsum("bqos,bqco->bqcs", x, w2.to(dtype))
                       + b2[..., None].to(dtype))
        x = (torch.einsum("bqos,bqco->bqcs", x, w3.to(dtype))
             + b3[..., None].to(dtype))
    return x[:, :, 0, :].float()


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
    if ch != CH or Cm > MAX_CM:
        raise ValueError(f"dynamic_mask_render: the kernel holds ch == {CH} "
                         f"channels and Cm <= {MAX_CM} feature columns in "
                         f"registers, got ch {ch}, Cm {Cm}")
    args = [t.float().contiguous() for t in (feats, inst_xy, w1, w2, w3, b1, b2, b3)]
    _build.check_inputs("dynamic_mask_render", *args)
    out = torch.empty((B, Q, HW), dtype=torch.float32, device=feats.device)
    # scratch: each query's weights as the kernel's mma fragment records
    records = torch.empty(_build.load_kernels().pctrans_render_records_floats(B, Q, Cm),
                          dtype=torch.float32, device=feats.device)
    _build.launch(dynamic_mask_render, "pctrans_render_fwd", *args, records, out,
                  B, Q, Hm, Wm, Cm, int(rel_coord), int(stride))
    return out


dynamic_mask_render.launches = 0
