"""The label-pair table of each scored image: the plain twin and the K8
wrapper.

K8 (``pctrans_torch/csrc/label_pairs.cu``) replaces no Pallas kernel: the
JAX package scores on the host in numpy
(``pctrans_tpu/inference/metrics_bbbc.py``, ``metrics_cvppp.py``).  It reads
the painted int16 label maps, the ground truth and, for CVPPP, the
foreground once, and writes the i32 table ``[B, G+1, C+1]`` whose entry
``[b, g, p]`` counts the pixels of image ``b`` with ground-truth id ``g``
and predicted id ``p``: every BBBC and CVPPP score reads only this table
(``inference/metrics_bbbc.py``, ``metrics_cvppp.py``).  Counts are exact
integers, so the kernel and the twin are bit-equal.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

GT_KINDS = {torch.int32: 0, torch.int16: 1, torch.uint16: 2}


def label_pairs_twin(labels: torch.Tensor, gt: torch.Tensor, max_gt: int, max_pred: int,
                     fg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`label_pairs`: one ``bincount`` of the
    keys (b, g, p) of the batch's pixels."""
    B = labels.shape[0]
    p = labels.reshape(B, -1).long()
    if fg is not None:
        p = p * (fg.reshape(B, -1) != 0)
    g = gt.reshape(B, -1).long()
    keep = (g >= 0) & (g <= max_gt) & (p >= 0) & (p <= max_pred)
    b = torch.arange(B, device=labels.device)[:, None]
    keys = ((b * (max_gt + 1) + g) * (max_pred + 1) + p)[keep]
    cells = B * (max_gt + 1) * (max_pred + 1)
    return torch.bincount(keys, minlength=cells).int().reshape(B, max_gt + 1, max_pred + 1)


def _check(labels, gt, max_gt, max_pred, fg):
    if labels.dim() != 3 or labels.dtype != torch.int16:
        raise ValueError("label_pairs: labels must be [B, H, W] int16; got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    if gt.dtype not in GT_KINDS or gt.shape != labels.shape:
        raise ValueError(f"label_pairs: gt must be int32, int16 or uint16 of the labels' "
                         f"shape {tuple(labels.shape)}; got {gt.dtype} {tuple(gt.shape)}")
    if fg is not None and (fg.dtype not in (torch.uint8, torch.bool)
                           or fg.shape != labels.shape):
        raise ValueError(f"label_pairs: fg must be u8 or bool of the labels' shape "
                         f"{tuple(labels.shape)}; got {fg.dtype} {tuple(fg.shape)}")
    cells = labels.shape[0] * (max_gt + 1) * (max_pred + 1)
    if max_gt < 0 or max_pred < 0 or cells >= 2 ** 31 or labels.numel() >= 2 ** 31 - 16:
        raise ValueError(f"label_pairs: a table of {labels.shape[0]} x {max_gt + 1} x "
                         f"{max_pred + 1} over {labels.numel()} pixels is out of range")


def label_pairs(labels: torch.Tensor, gt: torch.Tensor, max_gt: int, max_pred: int,
                fg: Optional[torch.Tensor] = None, impl: Optional[str] = None) -> torch.Tensor:
    """K8 wrapper: label maps [B, H, W] int16, ground truth [B, H, W] (int32,
    int16 or uint16) and optionally a u8/bool foreground [B, H, W] (outside
    it a pixel counts as predicted id 0) -> the i32 table [B, max_gt + 1,
    max_pred + 1].  A pixel with an id outside [0, max_gt] or [0, max_pred]
    is not counted, so the caller checks that each image sums to H x W.
    The CUDA kernel for CUDA tensors, the twin for CPU tensors or
    ``impl="twin"`` (see ``_build.use_kernel``); on a CUDA tensor it never
    falls back.  Each launch counts one ``label_pairs_kernel``
    (``utils/tracing.py``)."""
    max_gt, max_pred = int(max_gt), int(max_pred)
    _check(labels, gt, max_gt, max_pred, fg)
    if not _build.use_kernel(labels, impl, "label_pairs"):
        return label_pairs_twin(labels, gt, max_gt, max_pred, fg)
    _build.check_inputs("label_pairs", labels, gt, *(() if fg is None else (fg,)))
    B, H, W = labels.shape
    table = torch.empty((B, max_gt + 1, max_pred + 1), dtype=torch.int32,
                        device=labels.device)
    _build.launch(label_pairs, "pctrans_label_pairs", labels, gt, fg, table, B, H * W,
                  max_gt, max_pred, GT_KINDS[gt.dtype], counter="label_pairs_kernel")
    return table


label_pairs.launches = 0
