"""Padded, static-shape training targets from the integer label map (mirror
of ``pctrans_tpu/data/targets.py``), built on the label map's device.

Center points are the mean of each instance's pixel coordinates with
*both* x and y normalised by the image width, as the reference does.
"""

from __future__ import annotations

from typing import Dict

import torch


def targets_from_labels(labels: torch.Tensor, max_instances: int,
                        dtype: torch.dtype = torch.float32
                        ) -> Dict[str, torch.Tensor]:
    """labels: [B, H, W] integer instance map with consecutive ids (0 = bg).

    Returns dict:
      masks         [B, G, H, W] float (0/1)
      valid         [B, G] bool
      center_points [B, G, 2] normalised (x, y)
      fg_mask       [B, H, W] float
      seg           [B, H, W] int32 (ids above G set to 0)
    """
    B, H, W = labels.shape
    G = max_instances
    ids = torch.arange(1, G + 1, dtype=labels.dtype, device=labels.device)
    masks = (labels[:, None] == ids[None, :, None, None]).to(dtype)
    areas = masks.sum(dim=(2, 3))
    valid = areas > 0
    xs = torch.arange(W, dtype=dtype, device=labels.device)
    ys = torch.arange(H, dtype=dtype, device=labels.device)
    cnt = areas.clamp(min=1.0)
    cx = (masks * xs).sum(dim=(2, 3)) / cnt / W
    cy = (masks * ys[:, None]).sum(dim=(2, 3)) / cnt / W   # by W, like the reference
    return {
        "masks": masks,
        "valid": valid,
        "center_points": torch.stack([cx, cy], dim=-1),
        "fg_mask": (labels > 0).to(dtype),
        "seg": torch.where(labels > G, 0, labels).to(torch.int32),
    }
