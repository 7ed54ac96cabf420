"""Target generation, loss-weight maps, affinities, EDTs and blending (a
copy of ``pctrans_tpu/data/seg_targets.py``, which imports no JAX).

Equivalent of the reference ``connectomics/data/utils`` legacy-EM utilities:

* :func:`seg_to_targets` — the TARGET_OPT dispatch ('0' binary, '8'
  background, '1' synaptic polarity, '2' affinity, '3' small-object, '4'
  instance boundary, '5' instance EDT, '6' semantic EDT, '9' semantic)
  (data_segmentation.py:316-383 and its helpers :89-315).
* :func:`seg_to_weights` / :func:`weight_binary_ratio` /
  :func:`weight_unet2d` — per-target loss weights (data_weight.py:9-109).
* :func:`seg_to_aff` / ``mknhood*`` — affinity graphs
  (data_affinity.py:10-123).
* :func:`edt_semantic` / :func:`edt_instance` / :func:`energy_quantize` —
  distance-transform targets (data_transform.py:20-160).
* :func:`build_blending_matrix` — gaussian/bump sliding-window blending
  (data_blending.py:6-53).

numpy + scipy.ndimage only (window max/min via ``maximum_filter``/
``minimum_filter`` instead of the reference's im2col patches — identical
results with reflect padding).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy import ndimage
from scipy.ndimage import distance_transform_edt

RATES = Union[int, List[int], None]


# ------------------------------------------------------------- label helpers


def seg_widen_border(seg: np.ndarray, tsz_h: int = 1) -> np.ndarray:
    """Mark voxels whose (2h+1)^2 xy-window contains >1 positive id as
    background (Kisuk Lee A.1.4; data_segmentation.py:89-113)."""
    tsz = 2 * tsz_h + 1

    def widen2d(sl):
        mm = sl.max()
        p0 = ndimage.maximum_filter(sl, size=tsz, mode="reflect")
        z = np.where(sl == 0, mm + 1, sl)
        p1 = ndimage.minimum_filter(z, size=tsz, mode="reflect")
        return sl * (p0 == p1)

    if seg.ndim == 3:
        return np.stack([widen2d(seg[z]) for z in range(seg.shape[0])], 0)
    return widen2d(seg)


def seg_to_instance_bd(seg: np.ndarray, tsz_h: int = 1,
                       do_bg: bool = True) -> np.ndarray:
    """Binary instance contour map per slice (data_segmentation.py:144-196,
    im2col mode)."""
    tsz = 2 * tsz_h + 1
    mm = seg.max()
    bd = np.zeros(seg.shape, np.uint8)
    for z in range(seg.shape[0]):
        sl = seg[z]
        p0 = ndimage.maximum_filter(sl, size=tsz, mode="reflect")
        if do_bg:
            p1 = ndimage.minimum_filter(sl, size=tsz, mode="reflect")
            bd[z] = ((p0 > 0) & (p0 != p1)).astype(np.uint8)
        else:
            zf = np.where(sl == 0, mm + 1, sl)
            p1 = ndimage.minimum_filter(zf, size=tsz, mode="reflect")
            bd[z] = ((p0 != 0) & (p1 != 0) & (p0 != p1)).astype(np.uint8)
    return bd


def seg_to_small_seg(seg: np.ndarray, thres: int = 25, rr: int = 2) -> np.ndarray:
    """Mask of small per-slice connected components along each axis
    (data_segmentation.py:116-141)."""
    mask = np.zeros(seg.shape, np.uint8)

    def accumulate(sl, out, t):
        cc, _ = ndimage.label(sl > 0)
        counts = np.bincount(cc.ravel())
        small = np.zeros(len(counts), np.uint8)
        small[counts < t] = 1
        small[0] = 0
        out += small[cc]

    for z in np.where(seg.max(axis=(1, 2)) > 0)[0]:
        accumulate(seg[z], mask[z], thres)
    for y in np.where(seg.max(axis=(0, 2)) > 0)[0]:
        accumulate(seg[:, y], mask[:, y], thres // rr)
    for x in np.where(seg.max(axis=(0, 1)) > 0)[0]:
        accumulate(seg[:, :, x], mask[:, :, x], thres // rr)
    return mask


def seg2binary(label: np.ndarray, topt: str = "0") -> np.ndarray:
    if len(topt) == 1:
        return label > 0
    fg = np.zeros_like(label, bool)
    for idx in topt.split("-")[1:]:
        fg |= label == int(idx)
    return fg


def seg2polarity(label: np.ndarray, topt: str = "1") -> np.ndarray:
    """Synaptic polarity targets (data_segmentation.py:283-306): odd ids are
    pre-synaptic, even positive ids post-synaptic."""
    pos = (label % 2 == 1) & (label > 0)
    neg = (label % 2 == 0) & (label > 0)
    if len(topt) == 1:
        return np.stack([pos, neg, label > 0], 0).astype(np.float32)
    return np.maximum(pos.astype(np.int64), 2 * neg.astype(np.int64))


# ------------------------------------------------------------------ affinity


def mknhood2d(radius: int = 1) -> np.ndarray:
    assert radius == 1
    return np.array([[-1, 0], [0, -1]], np.int32)


def mknhood3d(radius: int = 1) -> np.ndarray:
    assert radius == 1
    return np.array([[-1, 0, 0], [0, -1, 0], [0, 0, -1]], np.int32)


def seg_to_aff(seg: np.ndarray, nhood: Optional[np.ndarray] = None,
               pad: str = "replicate") -> np.ndarray:
    """Affinity graph [E, *shape]: edge e is 1 where the voxel and its
    nhood[e]-shifted neighbor share a positive id (data_affinity.py:71-123)."""
    if nhood is None:
        nhood = mknhood3d(1) if seg.ndim == 3 else mknhood2d(1)
    n_edge = nhood.shape[0]
    aff = np.zeros((n_edge,) + seg.shape, np.float32)
    for e in range(n_edge):
        src = tuple(slice(max(0, -o), min(s, s - o))
                    for o, s in zip(nhood[e], seg.shape))
        dst = tuple(slice(max(0, o), min(s, s + o))
                    for o, s in zip(nhood[e], seg.shape))
        a = seg[src]
        b = seg[dst]
        aff[(e,) + src] = ((a == b) & (a > 0) & (b > 0)).astype(np.float32)
    if pad == "replicate":
        # boundary edges re-take the foreground value (data_affinity.py:114-122)
        for e in range(min(n_edge, seg.ndim)):
            sl = [slice(None)] * seg.ndim
            sl[e] = 0
            aff[(e,) + tuple(sl)] = (seg[tuple(sl)] > 0).astype(np.float32)
    return aff


# ----------------------------------------------------------------------- EDT


def edt_semantic(label: np.ndarray, mode: str = "2d",
                 alpha_fore: float = 8.0, alpha_back: float = 50.0) -> np.ndarray:
    """tanh of the signed fg/bg distance transform (data_transform.py:20-55)."""
    assert mode in ("2d", "3d")
    do_2d = label.ndim == 2
    resolution = (1.0, 1.0) if (mode == "2d" or do_2d) else (6.0, 1.0, 1.0)

    def edt_mask(mask, alpha):
        if (mask == 1).all():
            return np.ones_like(mask, float) * 5  # tanh(5) ~ 1
        return distance_transform_edt(mask, resolution) / alpha

    fore = (label != 0).astype(np.uint8)
    back = (label == 0).astype(np.uint8)
    if mode == "3d" or do_2d:
        distance = edt_mask(fore, alpha_fore) - edt_mask(back, alpha_back)
    else:
        distance = np.stack(
            [edt_mask(fore[i], alpha_fore) - edt_mask(back[i], alpha_back)
             for i in range(label.shape[0])], 0)
    return np.tanh(distance)


def distance_transform(label: np.ndarray, bg_value: float = -1.0,
                       relabel: bool = True, padding: bool = False,
                       resolution: Tuple[float, ...] = (1.0, 1.0)):
    """Per-instance normalized EDT energy (data_transform.py:87-135)."""
    eps = 1e-6
    pad_size = 2
    if relabel:
        label, _ = ndimage.label(label > 0)
    if padding:
        label = np.pad(label, pad_size)

    distance = np.full(label.shape, bg_value, np.float32)
    semantic = np.zeros(label.shape, np.uint8)
    for idx in np.unique(label):
        if idx == 0:
            continue
        region = label == idx
        region = ndimage.binary_fill_holes(region)
        semantic += region.astype(np.uint8)
        edt = distance_transform_edt(region, resolution)
        energy = edt / (edt.max() + eps)
        distance = np.maximum(distance, energy * region.astype(np.float32))
    if padding:
        sl = tuple(slice(pad_size, -pad_size) for _ in range(label.ndim))
        distance, semantic = distance[sl], semantic[sl]
    return distance, semantic


def edt_instance(label: np.ndarray, mode: str = "2d", quantize: bool = True,
                 resolution: Tuple[float, ...] = (1.0, 1.0, 1.0),
                 padding: bool = False) -> np.ndarray:
    """Instance EDT target, optionally quantized (data_transform.py:57-84)."""
    assert mode in ("2d", "3d")
    if label.ndim == 2:  # 2D labels: one z slice (same wrap as branch '4')
        label = label[None]
    if mode == "3d":
        distance, _ = distance_transform(label, resolution=resolution,
                                         padding=padding)
    else:
        distance = np.stack(
            [distance_transform(label[i], padding=padding)[0]
             for i in range(label.shape[0])], 0)
    return energy_quantize(distance) if quantize else distance


def energy_quantize(energy: np.ndarray, levels: int = 10) -> np.ndarray:
    """Continuous energy -> integer bin map (data_transform.py:138-149):
    bin edges [-1, 0, 1/levels, ..., (levels-1)/levels, 1.1], minus one —
    class 0 is energy < 0, classes 1..levels split [0, 1] (the network
    output has levels+1 channels for the CE loss)."""
    bins = np.concatenate([[-1.0], np.arange(levels) / levels, [1.1]])
    return (np.digitize(energy, bins) - 1).astype(np.int64)


# --------------------------------------------------------------- target maps


def seg_to_targets(label_orig: np.ndarray, topts: Sequence[str],
                   erosion_rates: RATES = None,
                   dilation_rates: RATES = None) -> List[np.ndarray]:
    """TARGET_OPT dispatch (data_segmentation.py:316-383)."""
    out: List[np.ndarray] = []
    for tid, topt in enumerate(topts):
        label = label_orig.copy()
        if erosion_rates is not None:
            r = erosion_rates[tid] if isinstance(erosion_rates, list) else erosion_rates
            label = seg_widen_border(label, r)
        if dilation_rates is not None:
            r = dilation_rates[tid] if isinstance(dilation_rates, list) else dilation_rates
            tsz = 2 * r + 1
            shape = (1, tsz, tsz) if label.ndim == 3 else (tsz, tsz)
            label = ndimage.grey_dilation(label, size=shape)

        code = topt[0]
        if code == "0":
            out.append(seg2binary(label, topt)[None].astype(np.float32))
        elif code == "8":
            out.append((label == 0)[None].astype(np.float32))
        elif code == "1":
            out.append(seg2polarity(label, topt))
        elif code == "2":
            out.append(seg_to_aff(label))
        elif code == "3":
            _, size_thres, zratio, _ = [int(x) for x in topt.split("-")]
            out.append((seg_to_small_seg(label, size_thres, zratio) > 0)[
                None].astype(np.float32))
        elif code == "4":
            _, bd_sz, do_bg = [int(x) for x in topt.split("-")]
            vol = label[None] if label.ndim == 2 else label
            bd = seg_to_instance_bd(vol, bd_sz, bool(do_bg))
            out.append((bd if label.ndim == 2 else bd[None]).astype(np.float32))
        elif code == "5":
            if len(topt) == 1:
                topt = "5-2d-0-0-5.0"
            _, mode, pad_, quant, z_res = topt.split("-")
            dist = edt_instance(label.copy(), mode,
                                resolution=(float(z_res), 1.0, 1.0),
                                quantize=bool(int(quant)),
                                padding=bool(int(pad_)))
            # quantized: int class map for CE (the 11 channels live on the
            # model-output side, SplitActivation); continuous: [1, ...] f32
            out.append(dist if bool(int(quant))
                       else dist[None].astype(np.float32))
        elif code == "6":
            if len(topt) == 1:
                topt = "6-2d-8-50"
            _, mode, a, b = topt.split("-")
            out.append(edt_semantic(label.copy(), mode, float(a), float(b))[
                None].astype(np.float32))
        elif code == "7":
            # cellpose diffusion-gradient flows; '7-0' appends the binary
            # foreground mask channel (data_segmentation.py:367-375)
            from .diffusion import seg2diffgrads

            grads = seg2diffgrads(label)
            if "0" in topt.split("-"):
                bin_mask = seg2binary(label, "0").astype(np.float32)
                if bin_mask.ndim < grads.ndim:
                    bin_mask = bin_mask[None]
                out.append(np.concatenate([grads, bin_mask], axis=0))
            else:
                out.append(grads)
        elif code == "9":
            out.append(label.astype(np.int64))
        else:
            raise NameError(f"Target option {topt} is not valid!")
    return out


# -------------------------------------------------------------- loss weights


def weight_binary_ratio(label: np.ndarray, mask: Optional[np.ndarray] = None,
                        dilate: bool = False) -> np.ndarray:
    """Class-balancing weight by fg/bg ratio (data_weight.py:33-72)."""
    if label.max() == label.min():
        return np.ones_like(label, np.float32)
    min_ratio = 5e-2
    fg = (label != 0).astype(np.float64)
    if mask is not None:
        m = mask.astype(fg.dtype)[None]
        ww = (fg * m).sum() / m.sum()
    else:
        ww = fg.sum() / fg.size
    ww = np.clip(ww, min_ratio, 1 - min_ratio)
    factor = max(ww, 1 - ww) / min(ww, 1 - ww)
    if dilate:
        n = fg.ndim
        assert n in (3, 4)
        struct = np.ones([1] * (n - 2) + [3, 3], bool)
        fg = ndimage.binary_dilation(fg != 0, struct).astype(np.float64)
    if ww > 1 - ww:  # fg dominates -> weight the background
        fg = 1 - fg
    weight = factor * fg + (1 - fg)
    if mask is not None:
        weight = weight * mask.astype(weight.dtype)[None]
    return weight.astype(np.float32)


def weight_unet2d(seg: np.ndarray, w0: float = 10.0, w1: float = 5.0,
                  sigma: float = 5.0) -> np.ndarray:
    """Classic U-Net border weights from the two nearest instances
    (data_weight.py:83-109)."""
    cc, n = ndimage.label(seg > 0)
    if n < 2:
        return np.clip((seg != 0).astype(np.float32) * w1, 1.0, max(w0, w1))
    dists = np.stack([distance_transform_edt(cc != i)
                      for i in range(1, n + 1)], 0)
    dists = np.partition(dists, 1, axis=0)
    d1, d2 = dists[0], dists[1]
    fg = (cc > 0).astype(np.float32)
    wmap = w0 * np.exp(-((d1 + d2) ** 2) / (2 * sigma ** 2)) * (1 - fg) + fg * w1
    return np.clip(wmap, 1.0, max(w0, w1)).astype(np.float32)


def weight_unet3d(seg: np.ndarray, w0: float = 10.0, w1: float = 5.0,
                  sigma: float = 5.0) -> np.ndarray:
    out = np.ones_like(seg, np.float32)
    for z in np.where((seg > 0).any(axis=(1, 2)))[0]:
        out[z] = weight_unet2d(seg[z], w0, w1, sigma)
    return out[None]


def seg_to_weights(targets, wopts, mask=None, seg=None):
    """WEIGHT_OPT dispatch (data_weight.py:9-30): per target, per loss."""
    out = []
    for wid, wopt in enumerate(wopts):
        ws = []
        for w in wopt:
            if w[0] == "1":
                ws.append(weight_binary_ratio(np.asarray(targets[wid]).copy(),
                                              mask, dilate=w == "1-1"))
            elif w[0] == "2":
                assert seg is not None
                _, w0, w1 = w.split("-")
                ws.append(weight_unet3d(seg, float(w0), float(w1)))
            else:
                ws.append(np.zeros((1,), int))
        out.append(ws)
    return out


# ------------------------------------------------------------------ blending


def blend_gaussian(sz, sigma: float = 0.2, mu: float = 0.0) -> np.ndarray:
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, sz[0], dtype=np.float32),
        np.linspace(-1, 1, sz[1], dtype=np.float32),
        np.linspace(-1, 1, sz[2], dtype=np.float32), indexing="ij")
    dd = np.sqrt(zz * zz + yy * yy + xx * xx)
    return (1e-4 + np.exp(-((dd - mu) ** 2) / (2.0 * sigma ** 2))).astype(np.float32)


def blend_bump(sz, t: float = 1.5) -> np.ndarray:
    zz, yy, xx = np.meshgrid(
        np.linspace(0, 1, sz[0] + 2, dtype=np.float32)[1:-1],
        np.linspace(0, 1, sz[1] + 2, dtype=np.float32)[1:-1],
        np.linspace(0, 1, sz[2] + 2, dtype=np.float32)[1:-1], indexing="ij")
    dd = (-((xx * (1 - xx)) ** -t) - ((yy * (1 - yy)) ** -t)
          - ((zz * (1 - zz)) ** -t))
    return (1e-4 + np.exp(dd - dd.max())).astype(np.float32)


def build_blending_matrix(sz, mode: str = "gaussian") -> np.ndarray:
    """Sliding-window blending weights (data_blending.py:6-11)."""
    assert mode in ("gaussian", "bump")
    return blend_gaussian(sz) if mode == "gaussian" else blend_bump(sz)
