"""Bridge from flax variables to the port's modules.

``load_flax_variables(model, variables)`` takes the JAX model's variables as
nested dicts of numpy arrays, ``{"params": ..., "frozen": ...,
"batch_stats": ...}``, and loads them into a :class:`PCTransModel`:

* Dense kernels ``[in, out]`` become ``nn.Linear`` weights ``[out, in]``;
* the attention projections of flax ``MultiHeadDotProductAttention`` become
  ``nn.Linear`` weights: ``query``/``key``/``value`` kernels
  ``[in, heads, head_dim]`` and their ``[heads, head_dim]`` biases, and
  ``out`` kernels ``[heads, head_dim, out]``, flattened over the heads;
* conv kernels ``[k..., Cin, Cout]`` (HWIO, DHWIO) become ``[Cout, Cin, k...]``;
* a Swin relative-position table that JAX sized to a clamped window
  (``(2w - 1)**2`` rows for a map of w < window tokens) fills the central
  offsets of the port's full-window table; the other offsets are 0;
* LayerNorm / GroupNorm / BatchNorm ``scale`` becomes ``weight``;
* the ``frozen`` collection fills the FrozenBatchNorm buffers;
* ``batch_stats`` fill the BatchNorm running statistics.

``load_flax_legacy_variables(model, variables)`` does the same for the legacy
zoo (``pctrans_torch/models/legacy``), whose modules carry the flax names:
a module's ``BatchNorm_i`` / ``GroupNorm_i`` is its ``norm{i}``, everything
else keeps its flax name, BotNet's bare ``pos_emb_h`` / ``pos_emb_w``
tables included (a RepVGG deploy tree's ``rbr_reparam`` is a conv like any
other).

Module names follow the flax tree with PyTorch containers
(``cross3`` -> ``cross_layers.3``, ``Dense_1`` -> ``layers.1``,
``layer2_block1`` -> ``blocks.2.1`` in a Swin backbone, ...).  Any
flax leaf without a torch entry, any torch entry left without a value, and
any shape mismatch raises.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(input_proj|input_gn|encoder_layer|decoder_layer|adapter|layer|"
                      r"seg_head|downsample|out_norm)(\d+)$")
_DECODER_LAYER = re.compile(r"^(cross|self|ffn)(\d+)$")
_BLOCK = re.compile(r"^(res\d)_block(\d+)$")
_SWIN_BLOCK = re.compile(r"^layer(\d+)_block(\d+)$")
_NORM = re.compile(r"^(FrozenBatchNorm|BatchNorm|GroupNorm)_(\d+)$")
_LEAF = {
    "params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
    "frozen": {"scale": "scale", "bias": "bias", "mean": "mean", "var": "var"},
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _segment(seg: str) -> str:
    for pat, fmt in ((_INDEXED, r"\1.\2"), (_DECODER_LAYER, r"\1_layers.\2"),
                     (_BLOCK, r"\1.\2"), (_SWIN_BLOCK, r"blocks.\1.\2")):
        if pat.match(seg):
            return pat.sub(fmt, seg)
    if seg.startswith("Dense_"):
        return "layers." + seg[len("Dense_"):]
    if seg == "Conv_0":
        return "conv"
    if _NORM.match(seg):
        return "norm"        # a ConvNorm's only norm
    return seg


def _backbone_module(path: Tuple[str, ...], params: Mapping) -> str:
    """backbone/<...>/<module> -> torch module name.  Backbone convs are
    named, its norms are numbered in call order: the stem's, then per block
    [shortcut,] conv1, conv2, conv3."""
    *scope, mod = path[1:]
    if not scope:                                      # stem
        return "backbone.stem." + ("conv" if mod == "stem_conv1" else "norm")
    block = _segment(scope[0])
    m = _NORM.match(mod)
    if m is None:
        return f"backbone.{block}.{mod}.conv"
    order = (["shortcut"] if "shortcut" in params["backbone"][scope[0]] else [])
    order += ["conv1", "conv2", "conv3"]
    return f"backbone.{block}.{order[int(m.group(2))]}.norm"


def torch_key(col: str, path: Tuple[str, ...], params: Mapping) -> str:
    """Torch state-dict key of the flax leaf ``col/path``."""
    if col not in _LEAF:
        raise KeyError(f"unknown flax collection {col!r}")
    *mods, leaf = path
    if col == "params" and leaf not in _LEAF[col]:
        mods, leaf_name = mods + [leaf], None        # a bare parameter
    else:
        if leaf not in _LEAF[col]:
            raise KeyError(f"unknown {col} leaf {'/'.join(path)}")
        leaf_name = _LEAF[col][leaf]
    if mods[:1] == ["backbone"] and len(mods) > 1 and \
            "stem_conv1" in params.get("backbone", {}):       # a ResNet's tree
        module = _backbone_module(tuple(mods), params)
    else:
        module = ".".join(_segment(s) for s in mods)
    return module if leaf_name is None else f"{module}.{leaf_name}"


def _to_torch(arr, leaf: str, module: str = "") -> torch.Tensor:
    """The torch layout of the flax leaf ``leaf`` of the module ``module``."""
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if leaf == "kernel" and t.ndim == 3:               # attention projections
        t = t.reshape(-1, t.shape[-1]) if module == "out" else t.reshape(t.shape[0], -1)
        return t.t().contiguous()
    if leaf == "bias" and t.ndim == 2:                 # [heads, head_dim]
        return t.reshape(-1)
    if leaf == "kernel" and t.ndim in (4, 5):         # [k..., Cin, Cout]
        return t.permute(t.ndim - 1, t.ndim - 2, *range(t.ndim - 2)).contiguous()
    if leaf == "kernel" and t.ndim == 2:
        return t.t().contiguous()                      # [in, out] -> [out, in]
    return t


def _full_window_table(t: torch.Tensor, shape) -> torch.Tensor:
    """A clamped window's table [(2w - 1)**2, heads] placed at the centre of
    the full window's [(2W - 1)**2, heads], the rest 0."""
    w, full = (round(math.sqrt(n)) for n in (t.shape[0], shape[0]))
    if t.shape == shape or t.ndim != 2 or t.shape[1] != shape[1] or \
            w * w != t.shape[0] or w % 2 == 0 or w > full:
        return t                           # equal, or the shape check raises
    out = torch.zeros(full, full, shape[1])
    lo = (full - w) // 2
    out[lo:lo + w, lo:lo + w] = t.reshape(w, w, -1)
    return out.reshape(shape)


def _load(model: nn.Module, variables: Mapping[str, Mapping], key_of) -> None:
    """Load flax variables into ``model``, naming each leaf's torch entry by
    ``key_of(col, path)``; a leaf without an entry, an entry loaded twice or
    left without a value, or a shape mismatch raises."""
    state = model.state_dict()
    new: Dict[str, torch.Tensor] = {}
    for col, tree in variables.items():
        for path, arr in _flatten(tree):
            key = key_of(col, path)
            name = f"{col}/{'/'.join(path)}"
            if key not in state:
                raise KeyError(f"flax {name} -> {key}: no such torch entry")
            if key in new:
                raise KeyError(f"flax {name} -> {key}: loaded twice")
            t = _to_torch(arr, path[-1], path[-2] if len(path) > 1 else "")
            if path[-1] == "relative_position_bias_table":
                t = _full_window_table(t, state[key].shape)
            if t.shape != state[key].shape:
                raise ValueError(f"flax {name} -> {key}: shape {tuple(t.shape)} "
                                 f"!= {tuple(state[key].shape)}")
            new[key] = t
    missing = [k for k in state
               if k not in new and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"torch entries without a flax value: {missing}")
    for k, v in state.items():
        new.setdefault(k, v)
    model.load_state_dict(new, strict=True)


def load_flax_variables(model: nn.Module,
                        variables: Mapping[str, Mapping]) -> None:
    """Load flax variables (nested dicts of numpy arrays) into ``model``."""
    params = variables.get("params", {})
    _load(model, variables, lambda col, path: torch_key(col, path, params))


_LEGACY_NORM = re.compile(r"^(BatchNorm|GroupNorm)_(\d+)$")
# bare parameters of the legacy zoo: BotNet's position tables [H | W, dim_head]
_LEGACY_RAW = ("pos_emb_h", "pos_emb_w")


def legacy_torch_key(col: str, path: Tuple[str, ...]) -> str:
    """Torch state-dict key of the flax leaf ``col/path`` of a legacy model."""
    *mods, leaf = path
    if col == "params" and leaf in _LEGACY_RAW:
        name = leaf
    elif col in ("params", "batch_stats") and leaf in _LEAF[col]:
        name = _LEAF[col][leaf]
    else:
        raise KeyError(f"unknown legacy leaf {col}/{'/'.join(path)}")
    return ".".join([_LEGACY_NORM.sub(r"norm\2", m) for m in mods] + [name])


def load_flax_legacy_variables(model: nn.Module,
                               variables: Mapping[str, Mapping]) -> None:
    """Load a legacy model's flax variables (``params`` and, with
    BatchNorm, ``batch_stats``) into ``model``."""
    _load(model, variables, legacy_torch_key)
