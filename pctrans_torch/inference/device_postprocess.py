"""Instance postprocess on the masks' device (mirror of
``pctrans_tpu/inference/device_postprocess.py:51-277``).

Every pixel-scale step runs where the binarized masks are; only
statistics cross to the host:

* device: per-mask areas and the K x K intersections (one batched matmul),
  the cluster mean-merge (a membership matmul), CVPPP's re-binarize and
  the merged masks' statistics, and the ascending-area argmax paint;
* host: the greedy dice clustering and MMI-NMS on [K] / [K, K] arrays,
  the same code as the numpy oracle (``postprocess.clusters_from_dice``,
  ``postprocess.nms_keep``).

Host <-> device traffic per batch: the packed [B, K, K+1(+1)] statistics
down, [B, K, K] membership (and [B, K] paint order) up, CVPPP's merged
statistics down, the [B, H, W] int16 label map down.

Exactness: the matmuls take 0/1 operands in f32 (exact under TF32 too)
and accumulate in f32, so areas, intersections and member counts are the
true integers (all below 2^24; a bf16 or f16 product would round counts
above 256 or 2048).  Merged values are fl(count / n) in f32, bit-equal to
numpy's ``mean`` over the members, so every threshold compare matches
``postprocess.instance_inference_cvppp`` / ``_bbbc``.  The one documented
difference: BBBC's paint order uses the exact rational cluster area (the
sum of member areas / n, in f64) where numpy sums H*W f32 values pairwise;
orders can differ only where two clusters' fractional areas tie within
f32 summation noise (~1e-7 relative).  Label maps are int16 for both
recipes (JAX narrows CVPPP's to u8, a transfer workaround).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..utils import tracing
from .postprocess import clusters_from_dice, dice_from_stats, nms_keep

CLUSTER_THRESHOLDS = {"cvppp": (0.5, 0.6), "bbbc": (0.15, 0.25)}   # (dice, merge)


# ---------------------------------------------------------------- device ops
# Every matmul below takes 0/1 operands in f32 and accumulates in f32: the
# counts are exact integers below 2^24.


def mask_stats(masks: torch.Tensor):
    """[B, K, H, W] binary (any dtype) -> (areas [B, K] i32, inter [B, K, K]
    i32)."""
    flat = masks.reshape(masks.shape[0], masks.shape[1], -1)
    f = flat.float()
    inter = torch.bmm(f, f.transpose(1, 2)).int()
    areas = flat.sum(dim=-1, dtype=torch.int32)
    return areas, inter


def packed_mask_stats(masks: torch.Tensor,
                      extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask statistics in one f32 array [B, K, K+1(+1)]: ``[..., :K]`` the
    intersections, ``[..., K]`` the areas, ``[..., K+1]`` the optional
    per-mask ``extra`` (the peak logits), so one host fetch carries them."""
    areas, inter = mask_stats(masks)
    cols = [inter.float(), areas[:, :, None].float()]
    if extra is not None:
        cols.append(extra[:, :, None].float())
    return torch.cat(cols, dim=-1)


def unpack_mask_stats(stats: np.ndarray):
    """Host-side inverse of :func:`packed_mask_stats` -> (areas, inter[,
    extra]) as f32 views."""
    K = stats.shape[1]
    if stats.shape[-1] > K + 1:
        return stats[:, :, K], stats[:, :, :K], stats[:, :, K + 1]
    return stats[:, :, K], stats[:, :, :K]


def _merge_fractions(masks: torch.Tensor, member: torch.Tensor,
                     nmem: torch.Tensor) -> torch.Tensor:
    """Mean of each cluster's members: [B, C, H*W] f32, count / n divided
    in f32 (numpy's ``mean``)."""
    flat = masks.reshape(masks.shape[0], masks.shape[1], -1)
    return torch.bmm(member.float(), flat.float()) / nmem[:, :, None]


def merge_binarize(masks: torch.Tensor, member: torch.Tensor,
                   nmem: torch.Tensor, thres2: float):
    """Mean-merge clusters and re-binarize (``mask_post`` with bd_flag).

    masks [B, K, H, W] binary u8; member [B, C, K] 0/1 membership; nmem
    [B, C] f32 member counts (1 on rows of no cluster).  Returns (merged u8
    [B, C, H, W], packed stats f32 [B, C, C+1])."""
    B, _, H, W = masks.shape
    # the f32 value of the threshold, as numpy compares an f32 mean with it
    merged = (_merge_fractions(masks, member, nmem) > float(np.float32(thres2)))
    merged = merged.to(torch.uint8).reshape(B, -1, H, W)
    return merged, packed_mask_stats(merged)


def _paint_argmax(stack: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Zero the slots at or past ``count``, put a background plane first and
    take the argmax over dim 1 (the first maximum wins, as in numpy)."""
    slot = torch.arange(stack.shape[1], device=stack.device)[None, :] < count[:, None]
    stack = stack * slot.reshape(slot.shape + (1,) * (stack.dim() - 2)).to(stack.dtype)
    stack = torch.cat([torch.zeros_like(stack[:, :1]), stack], dim=1)
    return torch.argmax(stack, dim=1).to(torch.int16)


def paint(masks: torch.Tensor, perm: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Gather masks [B, C, H, W] in the host's order ``perm`` [B, C], keep
    the first ``count`` [B] of each image, argmax-paint -> [B, H, W] i16."""
    g = torch.take_along_dim(masks, perm.long()[:, :, None, None], dim=1)
    return _paint_argmax(g, count)


def merge_paint_frac(masks: torch.Tensor, member: torch.Tensor, nmem: torch.Tensor,
                     perm: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """BBBC's tail: mean-merge with no re-binarize (merged masks stay
    fractional, ``mask_post`` without bd_flag) in the host's paint order,
    then argmax-paint -> [B, H, W] i16.  Membership rows are permuted first,
    so the clusters come out in paint order."""
    B, _, H, W = masks.shape
    perm = perm.long()
    member_p = torch.take_along_dim(member, perm[:, :, None], dim=1)
    nmem_p = torch.take_along_dim(nmem, perm, dim=1)
    frac = _merge_fractions(masks, member_p, nmem_p)
    return _paint_argmax(frac, count).reshape(B, H, W)


# ---------------------------------------------------------------- host glue
class DevicePostprocessor:
    """Batched instance inference on binarized mask stacks.

    ``__call__(masks, areas, inter)``: ``masks`` is the [B, K, H, W] u8
    stack on its device (``make_eval_step(..., with_stats=True)``),
    ``areas`` / ``inter`` its host-fetched statistics.  Returns the [B, H,
    W] int16 label maps of ``instance_inference_cvppp`` / ``_bbbc``.
    """

    MIN_AREA = 40.0
    NMS_THRES = 0.72

    def __init__(self, dataset: str):
        if dataset not in CLUSTER_THRESHOLDS:
            raise ValueError(f"unknown dataset {dataset!r}")
        self.dataset = dataset
        self.thres1, self.thres2 = CLUSTER_THRESHOLDS[dataset]

    def _membership(self, areas: np.ndarray, inter: np.ndarray):
        """Area filter and greedy clustering per image.  Returns (member
        [B, K, K] i8, nmem [B, K] f32, the clusters of each image)."""
        B, K = areas.shape
        member = np.zeros((B, K, K), np.int8)
        nmem = np.ones((B, K), np.float32)
        all_clusters: List[List[np.ndarray]] = []
        for b in range(B):
            valid = np.where(areas[b] > self.MIN_AREA)[0]
            clusters: List[np.ndarray] = []
            if valid.size:
                dice = dice_from_stats(areas[b, valid], inter[b][np.ix_(valid, valid)])
                clusters = [valid[np.asarray(m, np.int64)]
                            for m in clusters_from_dice(dice, self.thres1)]
            for c, mem in enumerate(clusters):
                member[b, c, mem] = 1
                nmem[b, c] = len(mem)
            all_clusters.append(clusters)
        return member, nmem, all_clusters

    def start(self, masks: torch.Tensor, areas: np.ndarray, inter: np.ndarray):
        """Greedy clustering on the host-fetched statistics, then the
        device tail: BBBC's merge and paint (returns the label tensor),
        CVPPP's merge and re-binarize (returns what :meth:`finish` needs)."""
        member, nmem, clusters = self._membership(areas, inter)
        dev = masks.device
        member_t = torch.from_numpy(member).to(dev)
        nmem_t = torch.from_numpy(nmem).to(dev)
        B, K = areas.shape
        if self.dataset == "bbbc":
            perm = np.zeros((B, K), np.int64)
            count = np.zeros((B,), np.int64)
            for b, cls in enumerate(clusters):
                # f64: member areas are integers below 2^24, their sum need
                # not be (300 masks of up to 361,920 pixels)
                frac_areas = np.array([areas[b, m].astype(np.float64).sum() / len(m)
                                       for m in cls])
                perm[b, :len(cls)] = np.argsort(frac_areas, kind="stable")
                count[b] = len(cls)
            return merge_paint_frac(masks, member_t, nmem_t, torch.from_numpy(perm).to(dev),
                                    torch.from_numpy(count).to(dev))
        merged, m_stats = merge_binarize(masks, member_t, nmem_t, self.thres2)
        return merged, m_stats, clusters

    def finish(self, pending) -> torch.Tensor:
        """CVPPP: MMI-NMS and the ascending-area order on the merged
        statistics (one host fetch, or the :class:`HostCopy` the pipeline
        started), then the paint.  Returns the label tensor on the masks'
        device."""
        if isinstance(pending, torch.Tensor):
            return pending
        merged, m_stats, clusters = pending
        if isinstance(m_stats, HostCopy):
            m_stats = m_stats.wait()
        else:
            with tracing.span("wait.merged_stats"):
                m_stats = m_stats.cpu()
        m_areas, m_inter = unpack_mask_stats(m_stats.numpy())
        B, K = m_areas.shape
        perm = np.zeros((B, K), np.int64)
        count = np.zeros((B,), np.int64)
        for b, cls in enumerate(clusters):
            nc = len(cls)
            if nc == 0:
                continue
            a = m_areas[b, :nc]
            scores = a / max(a.max(), 1e-5)
            keep = nms_keep(a, m_inter[b, :nc, :nc], scores, self.NMS_THRES)
            p = np.asarray(keep, np.int64)[np.argsort(a[keep], kind="stable")]
            perm[b, :len(p)] = p
            count[b] = len(p)
        dev = merged.device
        return paint(merged, torch.from_numpy(perm).to(dev), torch.from_numpy(count).to(dev))

    def __call__(self, masks: torch.Tensor, areas: np.ndarray,
                 inter: np.ndarray) -> np.ndarray:
        """Both stages back to back; the label maps on the host."""
        labels = self.finish(self.start(masks, areas, inter))
        with tracing.span("wait.labels"):
            return labels.cpu().numpy()


class HostCopy:
    """A device-to-host copy in flight: ``wait()`` returns the host tensor.

    On a CUDA tensor the copy goes into a pinned buffer of its own (one per
    call, so no buffer is reused while a copy into it is in flight) on the
    side ``stream``, which first waits for the work queued so far on the
    current stream; ``record_stream`` keeps the caching allocator from
    handing the source's memory out before the copy has read it, and the
    consumer waits on the event recorded after the copy, never on the whole
    device.  On the CPU the copy is done at once and there is no event.
    ``wait()`` is span ``wait.<name>``."""

    def __init__(self, t: torch.Tensor, stream: Optional["torch.cuda.Stream"] = None,
                 name: str = "host_copy"):
        self.event = None
        self.name = name
        if not t.is_cuda:
            self.host = t.detach().clone()
            return
        if stream is None:
            raise ValueError("an asynchronous copy of a CUDA tensor needs a side stream")
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(stream):
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(stream)
        t.record_stream(stream)

    def wait(self) -> torch.Tensor:
        with tracing.span("wait." + self.name):
            if self.event is not None:
                tracing.count("host_syncs")
                self.event.synchronize()
        return self.host


def copy_to_host_async(t: torch.Tensor,
                       stream: Optional["torch.cuda.Stream"] = None,
                       name: str = "host_copy") -> HostCopy:
    """Start ``t``'s copy to the host on ``stream`` (:class:`HostCopy`;
    its wait is span ``wait.<name>``)."""
    return HostCopy(t, stream, name)


def pipeline_batches(batches: Iterable, *stages):
    """Software pipeline of the eval loops (the JAX package's
    ``pipeline_batches``): ``stages`` are callables ``(batch, value) ->
    value``, stage k running one batch behind stage k-1, so each stage's
    device work and host copies have a batch interval to land before the
    next stage waits on them.  Stage 0 receives ``(batch, None)``.  Yields
    ``(batch, final value)`` in input order."""
    qs = [deque() for _ in stages]          # qs[i]: outputs of stages[i]

    def _advance(force: bool):
        for i in range(len(stages) - 1):
            while qs[i] and (force or len(qs[i]) >= 2):
                b, v = qs[i].popleft()
                qs[i + 1].append((b, stages[i + 1](b, v)))
        out = []
        while qs[-1] and (force or len(qs[-1]) >= 2):
            out.append(qs[-1].popleft())
        return out

    for batch in batches:
        qs[0].append((batch, stages[0](batch, None)))
        yield from _advance(False)
    yield from _advance(True)
