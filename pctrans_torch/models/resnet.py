"""ResNet backbone with detectron2 stage naming (mirror of
``pctrans_tpu/models/resnet.py:29-113``), NCHW, and the detectron2 R-50
pickle reader (``convert_d2_r50_pickle``, ``:114-259``).

Every convolution pads symmetrically by ``k // 2``, as the JAX side does
explicitly, so odd input sizes give the same grids: 530x500 gives res2
133x125, res3 67x63, res4 34x32, res5 17x16.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvNorm

BLOCKS_PER_STAGE = {14: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, bottleneck_ch: int,
                 stride: int, stride_in_1x1: bool, norm: str):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = (ConvNorm(in_ch, out_ch, 1, stride, norm, use_bias=False)
                         if in_ch != out_ch else None)
        self.conv1 = ConvNorm(in_ch, bottleneck_ch, 1, s1, norm, use_bias=False)
        self.conv2 = ConvNorm(bottleneck_ch, bottleneck_ch, 3, s3, norm,
                              use_bias=False)
        self.conv3 = ConvNorm(bottleneck_ch, out_ch, 1, 1, norm, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + shortcut)


class ResNet(nn.Module):
    """Stem (7x7/2 conv, norm, ReLU, 3x3/2 max-pool) and stages res2..res5."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = False,
                 norm: str = "FrozenBN"):
        super().__init__()
        self.stem = ConvNorm(3, 64, 7, 2, norm, use_bias=False)
        in_ch, out_ch, bott = 64, 256, 64
        self.stage_names = []
        for stage_idx, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
            name = f"res{stage_idx + 2}"
            first_stride = 1 if stage_idx == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(BottleneckBlock(
                    in_ch, out_ch, bott, first_stride if b == 0 else 1,
                    stride_in_1x1, norm))
                in_ch = out_ch
            self.add_module(name, nn.ModuleList(blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bott *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.stem(x))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outputs = {}
        for name in self.stage_names:
            for block in getattr(self, name):
                y = block(y)
            outputs[name] = y
        return outputs


_C2_BRANCH = {"branch1": "shortcut", "branch2a": "conv1", "branch2b": "conv2",
              "branch2c": "conv3"}
_C2_KEY = re.compile(r"res(\d)_(\d+)_(branch1|branch2a|branch2b|branch2c)"
                     r"_(w|b|bn_s|bn_b)$")


def _caffe2_to_d2_names(weights):
    """The detectron2 model-zoo ``R-50.pkl`` (Caffe2 names: ``conv1_w``,
    ``res{2..5}_{i}_branch{1,2a,2b,2c}_{w,bn_s,bn_b}``, an ``fc1000`` head,
    no running statistics) under detectron2's own names."""
    out = {}
    for k, v in weights.items():
        if not hasattr(v, "shape") or k.startswith("fc1000"):
            continue                                  # metadata, classifier
        if k == "conv1_w":
            out["stem.conv1.weight"] = v
        elif k == "res_conv1_bn_s":
            out["stem.conv1.norm.weight"] = v
        elif k == "res_conv1_bn_b":
            out["stem.conv1.norm.bias"] = v
        else:
            m = _C2_KEY.match(k)
            if m is None:
                raise KeyError(f"unrecognized Caffe2 R-50 key: {k!r}")
            stage, block, branch, suffix = m.groups()
            sfx = {"w": "weight", "b": "bias", "bn_s": "norm.weight",
                   "bn_b": "norm.bias"}[suffix]
            out[f"res{stage}.{block}.{_C2_BRANCH[branch]}.{sfx}"] = v
    return out


def convert_d2_r50_pickle(path: str, depth: int = 50,
                          conv1_bgr_to_rgb: bool = True) -> Dict[str, torch.Tensor]:
    """A detectron2 R-50 pickle (d2-native or Caffe2 model-zoo names) as the
    ``state_dict`` of :class:`ResNet` with FrozenBN norms.

    Missing running statistics default to mean 0 and var 1 - eps
    (detectron2's FrozenBatchNorm2d buffers, so the folded scale is the
    stored affine weight).  The Caffe2 weights expect BGR input; the loaders
    feed RGB, so conv1's input channels are flipped unless
    ``conv1_bgr_to_rgb=False`` (the reference's as-published behaviour).
    """
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    weights = data.get("model", data)
    if "conv1_w" in weights:
        weights = _caffe2_to_d2_names(weights)
        if conv1_bgr_to_rgb:
            weights["stem.conv1.weight"] = np.ascontiguousarray(
                np.asarray(weights["stem.conv1.weight"])[:, ::-1])

    out: Dict[str, torch.Tensor] = {}

    def put(src: str, dst: str):
        t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
        scale = np.asarray(weights[f"{src}.norm.weight"])
        out[f"{dst}.conv.weight"] = t(weights[f"{src}.weight"])
        out[f"{dst}.norm.scale"] = t(scale)
        out[f"{dst}.norm.bias"] = t(weights[f"{src}.norm.bias"])
        out[f"{dst}.norm.mean"] = t(weights.get(f"{src}.norm.running_mean",
                                                np.zeros_like(scale)))
        out[f"{dst}.norm.var"] = t(weights.get(f"{src}.norm.running_var",
                                               np.full_like(scale, 1.0 - 1e-5)))

    put("stem.conv1", "stem")
    for stage_idx, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
        for b in range(n_blocks):
            name = f"res{stage_idx + 2}.{b}"
            convs = ("shortcut",) if f"{name}.shortcut.weight" in weights else ()
            for conv in convs + ("conv1", "conv2", "conv3"):
                put(f"{name}.{conv}", f"{name}.{conv}")
    return out
