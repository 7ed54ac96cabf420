"""K8, the scored images' label-pair tables (``csrc/label_pairs.cu``), on the
card:

* bit-equal to its twin (``torch.bincount`` of the keys) at both eval path
  shapes (BBBC B=2, 520x696, G=148, C=300; CVPPP B=4, 530x500, G=12,
  C=100), with and without the foreground, for each ground-truth dtype, at
  odd widths and from misaligned addresses; ids out of range are not
  counted;
* the wrapper refuses wrong dtypes, devices and shapes;
* a batch through ``test_bbbc`` and through ``eval_cvppp`` (with a
  foreground) on the card launches K8 once, counts one
  ``label_pairs_kernel``, and scores as the map-taking functions do on the
  same labels.

Needs a CUDA card; skips without one.  On the card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_label_pairs_cuda.py
"""

import numpy as np
import pytest
import torch

from pctrans_torch.config import BBBC_RECIPE, CVPPP_RECIPE
from pctrans_torch.data.synthetic import make_blob_image, nuclei_scene_rule
from pctrans_torch.engine.evaluator import Evaluator
from pctrans_torch.inference import metrics_bbbc as mb
from pctrans_torch.inference import metrics_cvppp as mc
from pctrans_torch.models import PCTransModel
from pctrans_torch.ops.label_pairs import label_pairs
from pctrans_torch.utils import tracing

pytestmark = pytest.mark.cuda

BBBC = (2, (520, 696), 148, 300)
CVPPP = (4, (530, 500), 12, 100)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K8 has no CPU mode)")
    return torch.device("cuda", 0)


def _blocks(dev, g, B, hw, n_ids, block, dtype, offset=0):
    """[B, H, W] ids in [0, n_ids] in ``block``-sized squares (runs of equal
    ids, as painted maps have), ``offset`` elements into a larger buffer."""
    h, w = -(-hw[0] // block), -(-hw[1] // block)
    small = torch.randint(0, n_ids + 1, (B, h, w), device=dev, generator=g)
    full = small.repeat_interleave(block, 1).repeat_interleave(block, 2)
    full = full[:, :hw[0], :hw[1]].to(dtype).reshape(-1)
    buf = torch.zeros(full.numel() + offset, dtype=dtype, device=dev)
    buf[offset:] = full
    return buf[offset:].view(B, *hw)


def _inputs(dev, B, hw, max_gt, max_pred, gt_dtype=torch.int32, with_fg=False, offset=0,
            seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    labels = _blocks(dev, g, B, hw, max_pred, 7, torch.int16, offset)
    gt = _blocks(dev, g, B, hw, max_gt, 11, gt_dtype, offset)
    fg = _blocks(dev, g, B, hw, 1, 5, torch.uint8, offset) if with_fg else None
    return labels, gt, fg


def _assert_k8_equals_its_twin(labels, gt, max_gt, max_pred, fg=None):
    got = label_pairs(labels, gt, max_gt, max_pred, fg)
    want = label_pairs(labels, gt, max_gt, max_pred, fg, impl="twin")
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want), int((got - want).abs().max())
    return got


@pytest.mark.parametrize("shape", [BBBC, CVPPP], ids=["bbbc", "cvppp"])
@pytest.mark.parametrize("with_fg", [False, True], ids=["no_fg", "fg"])
@pytest.mark.parametrize("gt_dtype", [torch.int32, torch.int16, torch.uint16])
def test_k8_is_bit_equal_to_its_twin_at_the_path_shapes(dev, shape, with_fg, gt_dtype):
    B, hw, max_gt, max_pred = shape
    labels, gt, fg = _inputs(dev, B, hw, max_gt, max_pred, gt_dtype, with_fg)
    got = _assert_k8_equals_its_twin(labels, gt, max_gt, max_pred, fg)
    assert got.sum(dim=(1, 2)).tolist() == [hw[0] * hw[1]] * B


@pytest.mark.parametrize("case", ["odd width", "one row", "offset 1", "offset 3 with fg",
                                  "background only"])
def test_k8_takes_odd_widths_and_misaligned_addresses(dev, case):
    hw = {"odd width": (67, 63), "one row": (1, 37)}.get(case, (53, 61))
    offset = {"offset 1": 1, "offset 3 with fg": 3}.get(case, 0)
    labels, gt, fg = _inputs(dev, 3, hw, 20, 50, with_fg="fg" in case, offset=offset, seed=1)
    if case == "background only":
        labels, gt = torch.zeros_like(labels), torch.zeros_like(gt)
    got = _assert_k8_equals_its_twin(labels, gt, 20, 50, fg)
    assert got.sum(dim=(1, 2)).tolist() == [hw[0] * hw[1]] * 3


def test_k8_leaves_ids_out_of_range_uncounted(dev):
    labels, gt, _ = _inputs(dev, 2, (64, 80), 9, 30, seed=2)
    got = _assert_k8_equals_its_twin(labels, gt, 8, 29)
    assert (got.sum(dim=(1, 2)) < 64 * 80).all()
    gt[0, 0, :5] = -1
    _assert_k8_equals_its_twin(labels, gt, 9, 30)


def test_the_wrapper_refuses_wrong_dtypes_devices_and_shapes(dev):
    labels, gt, fg = _inputs(dev, 2, (16, 24), 5, 7, with_fg=True)
    with pytest.raises(ValueError):
        label_pairs(labels.int(), gt, 5, 7)
    with pytest.raises(ValueError):
        label_pairs(labels, gt.long(), 5, 7)
    with pytest.raises(ValueError):
        label_pairs(labels, gt[:, :8], 5, 7)
    with pytest.raises(ValueError):
        label_pairs(labels, gt, 5, 7, fg.float())
    with pytest.raises(RuntimeError):
        label_pairs(labels, gt.cpu(), 5, 7)
    strided = torch.zeros(2, 24, 16, dtype=torch.int32, device=dev).transpose(1, 2)
    with pytest.raises(RuntimeError):
        label_pairs(labels, strided, 5, 7)


def _batches(protocol, seed=0):
    """One batch of the protocol's eval shape: BBBC's nuclei scenes, or
    CVPPP's leaf scenes with a foreground that cuts some predictions."""
    rng = np.random.RandomState(seed)
    B, hw = (BBBC if protocol == "test_bbbc" else CVPPP)[:2]
    kw = {}
    if protocol == "test_bbbc":
        n_inst, radius = nuclei_scene_rule(hw)
        kw = {"n_instances": n_inst, "radius_px": radius}
    items = [make_blob_image(rng, hw, **kw) for _ in range(B)]
    batch = {"image": np.stack([i for i, _ in items]),
             "label": np.stack([l for _, l in items])}
    if protocol == "eval_cvppp":
        batch["fg"] = (rng.rand(B, *hw) > 0.2).astype(np.int32)
    return [batch]


def _scores_by_maps(protocol, batch, labels):
    """The parent's scoring: the map-taking functions on the label maps."""
    if protocol == "eval_cvppp":
        sbd = dic = 0.0
        for b in range(len(labels)):
            seg = labels[b].astype(np.uint16) * (batch["fg"][b] > 0).astype(np.uint16)
            gt = batch["label"][b].astype(np.uint16)
            sbd += mc.SymmetricBestDice(seg, gt)
            dic += abs(mc.DiffFGLabels(seg, gt))
        return {"SBD": sbd / len(labels), "absDiffFG": dic / len(labels)}
    scores = {"AJI": [], "F1": [], "detF1": [], "PQ": []}
    for b in range(len(labels)):
        gt = mb.remap_label(batch["label"][b])
        pred = mb.remap_label(labels[b])
        dq, _, pq = mb.get_fast_pq(gt, pred, match_iou=0.5)[0]
        for k, v in zip(scores, (mb.agg_jc_index(gt, pred), mb.pixel_f1(gt, pred), dq, pq)):
            scores[k].append(v)
    want = {}
    for k, v in scores.items():
        want[k], want[f"{k}_std"] = float(np.mean(v)), float(np.std(v))
    return want


@pytest.mark.parametrize("protocol", ["test_bbbc", "eval_cvppp"])
def test_a_batch_on_the_card_launches_k8_once_and_scores_as_the_maps_do(dev, protocol):
    config, top_k, dataset = ((BBBC_RECIPE, 160, "bbbc") if protocol == "test_bbbc"
                              else (CVPPP_RECIPE, 50, "cvppp"))
    model = PCTransModel(config, generator=torch.Generator().manual_seed(0))
    ev = Evaluator(model.to(dev).eval(), top_k=top_k, dataset=dataset)
    batches = _batches(protocol)
    before = label_pairs.launches
    tracing.reset()
    tracing.enable()
    try:
        res = getattr(ev, protocol)(batches)
        counts = tracing.table()["counts"]
    finally:
        tracing.disable()
        tracing.reset()
    assert label_pairs.launches - before == 1
    assert sum(n for name, _, _, n in counts if name == "label_pairs_kernel") == 1
    pairs = batches[0]["_label_pairs"]
    assert pairs.shape == (len(pairs), int(batches[0]["label"].max()) + 1,
                           config.num_queries + 1)
    labels = ev.predict_labels(batches[0]["image"])
    assert res == _scores_by_maps(protocol, batches[0], labels)
