"""K7, the masks' statistics (``csrc/mask_stats.cu``), on the card:

* bit-equal to the plain f32 path at the eval path's four shapes (CVPPP's
  top 50 and full-Q 100 masks at 530x500 in batches of 4, BBBC's top 160
  and full-Q 300 at 520x696 in batches of 2), at odd merged counts, at
  rows that start 4-byte or 1-byte aligned and from a misaligned address;
* all-ones masks, for the largest counts;
* its launch count and its ``mask_stats_kernel`` counter, one per call;
* the device postprocess on one CVPPP and one BBBC batch with K7 against
  the same postprocess on CPU copies, where the plain path serves.

Needs a CUDA card; skips without one.  On the card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_mask_stats_cuda.py
"""

import numpy as np
import pytest
import torch

from pctrans_torch.data.synthetic import make_blob_image, nuclei_scene_rule
from pctrans_torch.inference.device_postprocess import (DevicePostprocessor,
                                                        unpack_mask_stats)
from pctrans_torch.ops.mask_stats import packed_mask_stats
from pctrans_torch.utils import tracing

pytestmark = pytest.mark.cuda

CVPPP_HW, BBBC_HW = (530, 500), (520, 696)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K7 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def random_masks(dev, B, K, hw, seed=0):
    """0/1 u8 masks, each with a density of its own; mask 0 full, mask 1
    empty."""
    g = torch.Generator(device=dev).manual_seed(seed)
    density = torch.rand(1, K, 1, 1, generator=g, device=dev)
    masks = (torch.rand(B, K, *hw, generator=g, device=dev) < density).to(torch.uint8)
    masks[:, 0] = 1
    if K > 1:
        masks[:, 1] = 0
    return masks


def assert_k7_equals_the_plain_path(masks, extra=None):
    got = packed_mask_stats(masks, extra)
    want = packed_mask_stats(masks, extra, impl="twin")
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    return got


@pytest.mark.parametrize("B,K,hw", [(4, 50, CVPPP_HW), (4, 100, CVPPP_HW),
                                    (2, 160, BBBC_HW), (2, 300, BBBC_HW),
                                    (4, 37, CVPPP_HW), (4, 99, CVPPP_HW),
                                    (2, 129, BBBC_HW)])
def test_k7_is_bit_equal_to_the_plain_path_at_the_path_shapes(dev, B, K, hw):
    masks = random_masks(dev, B, K, hw, seed=K)
    peaks = torch.randn(B, K, device=dev)
    got = assert_k7_equals_the_plain_path(masks, peaks)
    assert torch.equal(got[..., K + 1], peaks)
    assert_k7_equals_the_plain_path(masks)


@pytest.mark.parametrize("case", ["rows 4-byte aligned", "rows 1-byte aligned",
                                  "address 8-byte aligned", "address 1-byte aligned"])
def test_k7_takes_any_row_pitch_and_address(dev, case):
    hw = {"rows 4-byte aligned": (530, 502), "rows 1-byte aligned": (67, 63)}.get(
        case, BBBC_HW)
    masks = random_masks(dev, 2, 70, hw, seed=1)
    if case.startswith("address"):
        offset = 8 if "8-byte" in case else 1
        buf = torch.empty(masks.numel() + offset, dtype=torch.uint8, device=dev)
        view = buf[offset:].view(masks.shape)
        view.copy_(masks)
        assert view.is_contiguous() and view.data_ptr() % 16 == offset
        masks = view
    assert_k7_equals_the_plain_path(masks)


def test_all_ones_masks_give_the_largest_counts(dev):
    masks = torch.ones(2, 300, *BBBC_HW, dtype=torch.uint8, device=dev)
    got = packed_mask_stats(masks)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full_like(got, float(BBBC_HW[0] * BBBC_HW[1])))


def test_launches_and_counter_move_by_one_per_call(dev):
    masks = random_masks(dev, 4, 50, CVPPP_HW)
    before = packed_mask_stats.launches
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("eval.dispatch", key=0):
            packed_mask_stats(masks)
            packed_mask_stats(masks, impl="twin")
        with tracing.span("eval.cluster", key=0):
            packed_mask_stats(masks[:, :37].contiguous())
    finally:
        tracing.disable()
    counts = [(name, path, n) for name, path, _, n in tracing.table()["counts"]
              if name == "mask_stats_kernel"]
    tracing.reset()
    assert packed_mask_stats.launches == before + 2
    assert sorted(counts) == [("mask_stats_kernel", ("eval.cluster",), 1),
                              ("mask_stats_kernel", ("eval.dispatch",), 1)]


def scene_masks(seed, B, K, hw, **scene):
    """Binarized masks as the eval step hands them over: each instance of a
    synthetic scene in up to three shifted copies (clusters to merge), the
    other masks sparse noise."""
    rng = np.random.RandomState(seed)
    out = np.zeros((B, K, *hw), np.uint8)
    for b in range(B):
        _, label = make_blob_image(rng, hw, **scene)
        q = 0
        for i in range(1, int(label.max()) + 1):
            for _ in range(3):
                if q < K:
                    out[b, q] = np.roll(label == i, rng.randint(-2, 3), axis=rng.randint(2))
                    q += 1
        while q < K:
            out[b, q] = rng.rand(*hw) < 0.02
            q += 1
    return torch.from_numpy(out)


@pytest.mark.parametrize("dataset", ["cvppp", "bbbc"])
def test_device_postprocess_with_k7_labels_as_the_plain_path(dev, dataset):
    if dataset == "cvppp":
        masks = scene_masks(3, 4, 50, CVPPP_HW)
    else:
        n_inst, radius = nuclei_scene_rule(BBBC_HW)
        masks = scene_masks(4, 2, 160, BBBC_HW, n_instances=n_inst, radius_px=radius)
    on_card = masks.to(dev)
    stats = packed_mask_stats(on_card).cpu().numpy()
    plain = packed_mask_stats(masks).numpy()
    np.testing.assert_array_equal(stats, plain)
    post = DevicePostprocessor(dataset)
    before = packed_mask_stats.launches
    labels = post(on_card, *unpack_mask_stats(stats))
    if dataset == "cvppp":                    # the merged masks' statistics
        assert packed_mask_stats.launches == before + 1
    want = post(masks, *unpack_mask_stats(plain))
    assert labels.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(labels, want)
    assert int(labels.max()) > 1
