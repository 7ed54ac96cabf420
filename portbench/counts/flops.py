"""Model FLOPs of one forward of one image, counted from the configuration
and the input size alone, the same whatever kernels implement the work.

The reference (``portbench/reference``) runs on fake tensors (shapes, no
data, no kernel) under ``FlopCounterMode``, which counts the convolutions,
the dense layers and the batched products (attention, the render's dynamic
1x1 convolutions); to that the deformable sampling is added, which aten
counts as no FLOPs (gathers and elementwise work): every sample of every
encoder layer, 4 corners x D channels of multiply-add plus the weighted
sum, ~10 FLOP per channel (``timing.msdeform_work``'s count with every
sample inside its map).  A training step counts three forwards (forward and
backward).  Counting takes a few seconds, so a count is kept in
``build/portbench/`` by its configuration and size.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import torch

from .. import bench
from ..reference.config import ModelConfig
from ..reference.model import PCTransReference

ENC_LEVELS = (8, 16, 32)          # the encoder's feature strides (res3..res5)


def aten_flops(sizes: Dict, hw: Tuple[int, int], batch: int = 1) -> int:
    """``FlopCounterMode``'s count of one reference forward at ``hw``, on
    fake tensors, in f32 (the count does not depend on the dtype)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    config = ModelConfig.from_sizes({**sizes, "dtype": "float32"})
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = PCTransReference(config)
        model.eval()
        model.requires_grad_(False)
        x = torch.zeros(batch, hw[0], hw[1], 3)
        with FlopCounterMode(display=False) as counter:
            model(x)
    return int(counter.get_total_flops())


def level_sizes(hw: Tuple[int, int]):
    """The encoder's (H, W) per level: each stride halves the size with
    ceil, as the ResNet's stride-2 convolutions and pool do."""
    h, w = hw
    out = []
    for stride in (2, 4, 8, 16, 32):
        h, w = (h + 1) // 2, (w + 1) // 2
        if stride in ENC_LEVELS:
            out.append((h, w))
    return out


def sampling_flops(sizes: Dict, hw: Tuple[int, int], batch: int = 1) -> int:
    """The deformable sampling of every encoder layer, every sample
    counted inside its map."""
    c = ModelConfig.from_sizes(sizes)
    lq = sum(h * w for h, w in level_sizes(hw))
    d = c.conv_dim // c.nheads
    return batch * c.enc_layers * lq * c.nheads * len(ENC_LEVELS) * c.enc_points * (10 * d + 10)


def forward_flops(sizes: Dict, hw: Tuple[int, int]) -> float:
    """Model FLOPs of one forward of one image at ``hw``."""
    key = json.dumps({"sizes": sizes, "hw": list(hw)}, sort_keys=True)
    path = bench.BUILD / "flops.json"
    cache = {}
    if path.exists():
        with open(path) as f:
            cache = json.load(f)
    if key not in cache:
        cache[key] = aten_flops(sizes, hw) + sampling_flops(sizes, hw)
        bench.BUILD.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(cache, f)
    return float(cache[key])
