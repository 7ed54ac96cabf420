"""The port's device postprocess on CPU tensors against the port's numpy
oracle and the JAX package's ``DevicePostprocessor``, on the regimes of
``tests/test_device_postprocess.py``: duplicate-query clusters, NMS
suppression, area filtering, empty images.  Label maps and statistics are
compared exactly: every count is an integer below 2^24 and every merged
value the same f32 quotient on all three sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_torch.data.synthetic import make_blob_image
from pctrans_torch.inference import device_postprocess as dp
from pctrans_torch.inference.postprocess import (instance_inference_bbbc,
                                                 instance_inference_cvppp)
from pctrans_torch.ops.mask_stats import mask_stats_twin
from pctrans_tpu.inference import device_postprocess as jax_dp

torch.set_num_threads(1)

THRESHOLD = {"cvppp": 0.69, "bbbc": 0.05}
ORACLE = {"cvppp": instance_inference_cvppp, "bbbc": instance_inference_bbbc}


def _fake_probs(rng, Q=24, H=96, W=80, dup=3, noise=0.15, rest=0.3):
    """Overlapping duplicate-query stacks (the JAX test's construction), so
    clustering, NMS and painting all do real work; ``noise`` and ``rest``
    scale the uniform noise on the instances' queries and the others'."""
    _, label = make_blob_image(rng, size=(H, W), n_instances=(6, 10))
    probs = np.zeros((Q, H, W), np.float32)
    qi = 0
    for i in range(1, int(label.max()) + 1):
        m = (label == i).astype(np.float32)
        for _ in range(min(dup, Q - qi)):
            n = rng.rand(H, W).astype(np.float32) * noise
            shifted = np.roll(m, rng.randint(-2, 3), axis=rng.randint(2))
            probs[qi] = np.clip(shifted * (0.75 + 0.2 * rng.rand()) + n, 1e-4, 1 - 1e-4)
            qi += 1
    while qi < Q:
        probs[qi] = rng.rand(H, W).astype(np.float32) * rest
        qi += 1
    return probs


def _labels_three_ways(dataset, probs):
    """(port device path, JAX device path, port numpy oracle) label maps."""
    masks = (probs > THRESHOLD[dataset]).astype(np.uint8)
    areas, inter = (t.numpy() for t in mask_stats_twin(torch.from_numpy(masks)))
    ours = dp.DevicePostprocessor(dataset)(torch.from_numpy(masks), areas, inter)
    j_areas, j_inter = (np.asarray(a) for a in jax_dp._stats(jnp.asarray(masks)))
    ref = jax_dp.DevicePostprocessor(dataset)(jnp.asarray(masks), j_areas, j_inter)
    oracle = np.stack([ORACLE[dataset](p) for p in probs])
    return ours, np.asarray(ref), oracle


def _assert_equal_three_ways(dataset, probs):
    ours, ref, oracle = _labels_three_ways(dataset, probs)
    assert ours.dtype == np.int16 and ours.shape == probs.shape[:1] + probs.shape[2:]
    np.testing.assert_array_equal(ours, oracle)
    np.testing.assert_array_equal(ours, ref.astype(np.int16))
    return ours


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cvppp_matches_the_oracle_and_jax(seed):
    rng = np.random.RandomState(seed)
    labels = _assert_equal_three_ways("cvppp", np.stack([_fake_probs(rng) for _ in range(2)]))
    assert labels.max() >= 3


@pytest.mark.parametrize("seed", [0, 3])
def test_bbbc_matches_the_oracle_and_jax(seed):
    rng = np.random.RandomState(seed)
    # the 0.05 threshold keeps the noise too: every mask covers the image
    _assert_equal_three_ways("bbbc", np.stack([_fake_probs(rng, Q=30, dup=2)
                                               for _ in range(2)]))


@pytest.mark.parametrize("seed", [0, 3])
def test_bbbc_with_separate_instances_matches_the_oracle_and_jax(seed):
    """Noise under the 0.05 threshold: duplicate queries merge into
    fractional masks that overlap their neighbours, painted in the order of
    their fractional areas."""
    rng = np.random.RandomState(seed)
    probs = np.stack([_fake_probs(rng, Q=30, dup=3, noise=0.04, rest=0.045)
                      for _ in range(2)])
    assert _assert_equal_three_ways("bbbc", probs).max() >= 4


@pytest.mark.parametrize("dataset", ["cvppp", "bbbc"])
def test_empty_and_mixed_batch(dataset):
    """An image whose masks all stay under the threshold paints background
    while its batchmate paints normally."""
    real = _fake_probs(np.random.RandomState(7))
    labels = _assert_equal_three_ways(dataset, np.stack([np.full_like(real, 0.01), real]))
    assert labels[0].max() == 0 and labels[1].max() >= 1


@pytest.mark.parametrize("dataset", ["cvppp", "bbbc"])
def test_area_filter_only_batch(dataset):
    """A mask that clears the threshold with 25 pixels (<= 40) is dropped."""
    probs = np.zeros((1, 8, 64, 64), np.float32)
    probs[0, 0, :5, :5] = 0.9
    probs[0, 1, 10:20, 10:20] = 0.9
    assert _assert_equal_three_ways(dataset, probs).max() == 1


def test_bbbc_paint_order_uses_the_exact_cluster_area():
    """The one documented difference from the numpy oracle.  Mask B (636
    pixels) comes first, then three rectangles that cluster into A, whose
    mean has the exact area 1908 / 3 = 636 but an f32 sum of 635.99994.
    B covers 16 pixels of A's core, where both merged masks are 1.0.  By
    the exact areas (the device path, as JAX's) the tie keeps the cluster
    order and B paints those pixels; by numpy's f32 sums A goes first and
    paints them.  Nothing else differs but the label ids."""
    masks = np.zeros((1, 4, 64, 64), np.uint8)
    masks[0, 0, 20:24, 21:25] = 1
    masks[0, 0, 54, :44] = 1
    masks[0, 0, 55:] = 1
    masks[0, 1, 2:24, 2:25] = 1
    masks[0, 2, 5:34, :26] = 1
    masks[0, 3, :24, 3:30] = 1
    f = masks[0, 1:].astype(np.float32)
    assert masks[0, 0].sum() * 3 == f.sum() and f.mean(axis=0).reshape(-1).sum() != 636
    ours, ref, oracle = _labels_three_ways("bbbc", masks.astype(np.float32))
    np.testing.assert_array_equal(ours, ref.astype(np.int16))
    core = np.zeros((64, 64), bool)
    core[20:24, 21:25] = True
    assert (ours[0][core] == 1).all() and ours[0].max() == 2       # B painted first
    swapped = np.array([0, 2, 1], np.int16)[oracle[0]]             # oracle: A is 1
    np.testing.assert_array_equal(ours[0] != swapped, core)


def _big_masks(seed, K=6, hw=(70, 90)):
    """Masks of 2,049 to 6,300 pixels with odd areas and intersections, and
    an extra column of logits."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((2, K, *hw), np.uint8)
    for b in range(2):
        for k in range(K):
            h, w = rng.randint(41, hw[0] + 1), rng.randint(51, hw[1] + 1)
            y, x = rng.randint(0, hw[0] - h + 1), rng.randint(0, hw[1] - w + 1)
            masks[b, k, y:y + h, x:x + w] = 1
            masks[b, k, y, x] = 1 - masks[b, k, y, x] if (h * w) % 2 == 0 else 1
    extra = rng.randn(2, K).astype(np.float32) * 5
    return masks, extra


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_stats_are_exact_integers_above_2048_and_equal_jax(seed):
    """Areas and intersections above 2048 pixels: a bf16 or f16 product
    would round them; the packed array equals JAX's."""
    masks, extra = _big_masks(seed)
    flat = masks.reshape(2, masks.shape[1], -1).astype(np.int64)
    ours = dp.packed_mask_stats(torch.from_numpy(masks), torch.from_numpy(extra)).numpy()
    areas, inter, peaks = dp.unpack_mask_stats(ours)
    np.testing.assert_array_equal(areas, flat.sum(-1))
    np.testing.assert_array_equal(inter, np.einsum("bkp,bjp->bkj", flat, flat))
    np.testing.assert_array_equal(peaks, extra)
    assert areas.min() > 2048 and (areas % 2 == 1).all() and inter.max() > 2048
    ref = np.asarray(jax_dp.packed_mask_stats(jnp.asarray(masks), jnp.asarray(extra)))
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    a, i = mask_stats_twin(torch.from_numpy(masks))
    assert a.dtype == i.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), areas.astype(np.int32))


def test_member_counts_are_exact_above_2048_members():
    """A cluster of 2,101 members: pixel p is in members 0..p-1, so its
    count is p.  Re-binarizing at (c + 0.5) / 2101 for odd c between 2048
    and 2100 keeps exactly the pixels with count > c, as numpy's mean does;
    an f16 (or bf16) count would round odd counts to even ones."""
    K = 2101
    p = np.arange(K + 1)
    masks = (np.arange(K)[:, None] < p[None, :]).astype(np.uint8).reshape(1, K, 2, (K + 1) // 2)
    member = torch.ones(1, 1, K, dtype=torch.int8)
    nmem = torch.full((1, 1), float(K))
    mean = masks[0].reshape(K, -1).astype(np.float32).mean(axis=0)
    for c in range(2049, K, 2):
        t = (c + 0.5) / K
        merged, stats = dp.merge_binarize(torch.from_numpy(masks), member, nmem, t)
        got = merged.numpy().reshape(-1)
        np.testing.assert_array_equal(got, (mean > np.float32(t)).astype(np.uint8))
        np.testing.assert_array_equal(got, (p > c).astype(np.uint8))
        assert stats.numpy()[0, 0, 1] == K - c


def test_merge_paint_frac_divides_as_numpy_mean():
    """BBBC's fractional merge is count / n in f32, bit-equal to numpy's
    mean over the members.  Clusters of 3, 9, 27, 5, 15, ... members over
    random masks tie at many pixels (1/3 = 3/9); the first in paint order
    must win each tie, as in numpy's argmax over the means (and JAX's) --
    a product with fl(1/n) instead breaks some of those ties."""
    rng = np.random.RandomState(0)
    K, sizes = 120, [3, 9, 27, 5, 15, 45, 7, 21, 49, 11, 33, 13, 39]
    masks = (rng.rand(1, K, 40, 50) < 0.5).astype(np.uint8)
    member = np.zeros((1, K, K), np.int8)
    nmem = np.ones((1, K), np.float32)
    for c, n in enumerate(sizes):
        member[0, c, rng.choice(K, n, replace=False)] = 1
        nmem[0, c] = n
    perm = np.arange(K)[None].copy()
    rng.shuffle(perm[0, :len(sizes)])
    count = np.array([len(sizes)])
    got = dp.merge_paint_frac(*(torch.from_numpy(a) for a in (masks, member, nmem, perm, count)))
    f = masks[0].astype(np.float32)
    means = [f[member[0, perm[0, i]] == 1].mean(axis=0) for i in range(len(sizes))]
    ref = np.argmax(np.stack([np.zeros_like(means[0])] + means), axis=0).astype(np.int16)
    np.testing.assert_array_equal(got.numpy()[0], ref)
    assert set(np.unique(ref)) == set(range(1, len(sizes) + 1))     # each wins somewhere
    jax_ref = jax_dp._merge_paint_frac(*(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
                                         for a in (masks, member, nmem, perm, count)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ref))


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        dp.DevicePostprocessor("cellpose")
