"""The yardstick's arithmetic: the H100's peaks, the roofline bound, the
operations and bytes of each hand-written kernel's call, host-clock spans
and the percentile.

``bound_ms``, ``msdeform_samples_inside``, ``msdeform_work``,
``msdeform_backward_work`` and K3's and K4's counts are copies of
``chip_smoke.py``'s (which gated and timed the kernels alone; the CPU tests
hold them equal); here they serve the kernels inside the path.  The device
count of samples stays on the device, so counting reads nothing back.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12


TRACE_TRIES = 8                # traced windows before the fullest is used


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, flops: float, flop_rate: float = PEAK_F32_FLOP_PER_S
             ) -> Tuple[float, str]:
    """The least time the card could take, in ms: the larger of the bytes
    moved (each input read once, each output written once) over HBM's rate
    and the operations over the rate of the unit that runs them; and which
    of the two it is."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def msdeform_samples_inside(shapes, loc) -> torch.Tensor:
    """Samples with a corner inside their level's map (a 0-d tensor on
    ``loc``'s device: no host read): an outside sample adds zero, so only
    these need operations."""
    n = loc.new_zeros((), dtype=torch.int64)
    for lid, (H, W) in enumerate(shapes):
        x = loc[:, :, :, lid, :, 0] * W - 0.5
        y = loc[:, :, :, lid, :, 1] * H - 0.5
        n = n + ((x > -1) & (x < W) & (y > -1) & (y < H)).sum()
    return n


def msdeform_work(value, shapes, loc, w) -> Tuple[int, torch.Tensor]:
    """(bytes, FLOP as a 0-d tensor) of one forward call (K1): each input
    read once and the output written once; per sample inside the map, 4
    corners x D channels of multiply-add plus the weighted sum, ~10 FLOP
    per channel."""
    B, Lq, M, D = value.shape[0], loc.shape[1], value.shape[2], value.shape[3]
    out_bytes = B * Lq * M * D * value.element_size()
    flops = msdeform_samples_inside(shapes, loc) * (10 * D + 10)
    return nbytes(value, loc, w) + out_bytes, flops


def msdeform_backward_work(value, shapes, loc, w, grad) -> Tuple[int, torch.Tensor]:
    """(bytes, FLOP as a 0-d tensor) of one K2 call: value, loc, w and grad
    read once; f32 d_value, d_loc and d_w written once; ~34 FLOP per inside
    sample and channel."""
    n_bytes = nbytes(value, loc, w, grad) + 4 * (value.numel() + loc.numel() + w.numel())
    return n_bytes, msdeform_samples_inside(shapes, loc) * 34 * value.shape[3]


def render_work(feats, inst_xy, w1, w2, w3, b1, b2, b3, hw, out) -> Tuple[int, int]:
    """(bytes, FLOP) of one K3 call: three 1x1 layers per (query, pixel),
    ch*(Cm+2) + ch*ch + ch multiply-adds; f32-accurate on the tensor cores
    costs three TF32 products each (3xTF32): the caller counts these
    operations three times against the TF32 peak (``probes.RANGE_UNITS``)."""
    B, Q, ch = w1.shape[0], w1.shape[1], w1.shape[2]
    Cm = feats.shape[2]
    Hm, Wm = hw
    flops = 2 * B * Q * Hm * Wm * (ch * (Cm + 2) + ch * ch + ch)
    return nbytes(feats, inst_xy, w1, w2, w3, b1, b2, b3, out), flops


def resize_binarize_work(x, out) -> Tuple[int, int]:
    """(bytes, FLOP) of one K4 call: two lerps along each axis and a
    compare, ~10 FLOP per output pixel."""
    return nbytes(x, out), 10 * out.numel()


class Clock:
    """Host-clock spans by name, in ms, kept in memory."""

    def __init__(self):
        self.spans = {}

    def add(self, name: str, ms: float) -> None:
        self.spans.setdefault(name, []).append(ms)

    def reset(self) -> None:
        self.spans.clear()


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0..1) of ``values`` (numpy's linear rule); None
    when empty."""
    return float(np.quantile(values, q)) if len(values) else None
