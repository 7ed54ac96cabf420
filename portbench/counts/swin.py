"""Counts for a Swin configuration: model FLOPs of one forward of one
image, and the bytes and operations of one call of K6, Swin's fused
window attention.

The forward is counted as ``flops.py`` counts the ResNet recipe's: the
reference (``reference/model_swin.py``) on fake tensors under
``FlopCounterMode`` (the patch embedding, every block's dense layers and
attention products over the padded windows, the patch merges, the pixel
decoder and the decoder) plus the deformable sampling, which aten counts
as none.  Counts are kept in ``build/portbench/`` by configuration and
size.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import torch

from .. import bench
from ..reference.config import ModelConfig
from ..reference.model_swin import PCTransSwinReference, SwinModelConfig
from ..timing import nbytes
from .flops import sampling_flops

HEAD_DIM = 32


def aten_flops(sizes: Dict, hw: Tuple[int, int], batch: int = 1) -> int:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    config = SwinModelConfig.from_sizes({**sizes, "dtype": "float32"})
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = PCTransSwinReference(config)
        model.eval()
        model.requires_grad_(False)
        x = torch.zeros(batch, hw[0], hw[1], 3)
        with FlopCounterMode(display=False) as counter:
            model(x)
    return int(counter.get_total_flops())


def forward_flops(sizes: Dict, hw: Tuple[int, int]) -> float:
    """Model FLOPs of one forward of one image at ``hw``."""
    key = json.dumps({"sizes": sizes, "hw": list(hw)}, sort_keys=True)
    path = bench.BUILD / "flops_swin.json"
    cache = {}
    if path.exists():
        with open(path) as f:
            cache = json.load(f)
    if key not in cache:
        recipe = {f.name for f in dataclasses.fields(ModelConfig)}
        cache[key] = aten_flops(sizes, hw) + sampling_flops(
            {k: v for k, v in sizes.items() if k in recipe}, hw)
        bench.BUILD.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(cache, f)
    return float(cache[key])


def window_attn_work(args, out) -> Tuple[int, int]:
    """(bytes, FLOP) of one K6 call ``window_attention(qkv, table, heads,
    ws, ...)``: q, k, v and the table read once, the output written once;
    the two products, 2 N^2 x 32 multiply-adds per window and head."""
    qkv, table, heads = args[0], args[1], args[2]
    windows, n = qkv.shape[0], qkv.shape[1]
    return (nbytes(qkv, out) + table.numel() * 4,
            4 * n * n * HEAD_DIM * windows * heads)
