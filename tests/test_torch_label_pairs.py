"""The scores from the label-pair table (``ops/label_pairs.py``, the twin of
K8; ``*_from_table`` in ``inference/metrics_bbbc.py`` and
``metrics_cvppp.py``) against the map-taking functions and the JAX
package's, bit for bit: random maps and the cases the scores treat apart
(gaps in the ids, no prediction, no ground truth, every IoU zero, ties, a
lowest id that is not 0, CVPPP's foreground).  The twin's table holds every
pixel once; the wrapper refuses what the kernel cannot take; and
``test_bbbc`` / ``eval_cvppp`` through the label pipeline give the scores
of the map-taking path on the pipeline's own labels."""

import numpy as np
import pytest
import torch

from pctrans_torch.engine.evaluator import Evaluator
from pctrans_torch.inference import metrics_bbbc as mb
from pctrans_torch.inference import metrics_cvppp as mc
from pctrans_torch.ops.label_pairs import label_pairs, label_pairs_twin
from pctrans_tpu.inference import metrics_bbbc as jax_bbbc
from pctrans_tpu.inference import metrics_cvppp as jax_cvppp
from test_torch_evaluator import _batches, _model
from test_torch_pipeline import _padded

torch.set_num_threads(1)


def _blocks(rng, shape, n_ids, block):
    """A label map of ``block``-sized squares with ids in [0, n_ids]."""
    h, w = -(-shape[0] // block), -(-shape[1] // block)
    small = rng.randint(0, n_ids + 1, size=(h, w))
    return small.repeat(block, 0).repeat(block, 1)[:shape[0], :shape[1]]


def _pair(case, seed=0):
    """(gt int32, pred int16) [H, W] for one case."""
    rng = np.random.RandomState(seed)
    gt = _blocks(rng, (37, 45), 9, 5).astype(np.int32)
    pred = _blocks(rng, (37, 45), 12, 4).astype(np.int16)
    if case == "gaps":                    # ids missing in both maps
        gt = np.where(np.isin(gt, (2, 5)), 0, gt * 3)
        pred = np.where(np.isin(pred, (1, 4, 7)), 0, pred)
    elif case == "no_prediction":
        pred = np.zeros_like(pred)
    elif case == "no_gt":
        gt = np.zeros_like(gt)
    elif case == "every_iou_zero":
        # GT 3 and GT 4 lie on background: GT 3 with prediction 1 still
        # unused at its turn, GT 4 after GT 3 used it up
        gt, pred = np.zeros((20, 30), np.int32), np.zeros((20, 30), np.int16)
        gt[2:8, 2:8], gt[10:14, 2:8], gt[2:8, 20:26], gt[16:20, 10:14] = 3, 1, 2, 4
        pred[10:20, 2:8], pred[2:8, 22:30], pred[15:20, 20:30] = 2, 2, 1
        pred[12:14, 2:8] = 3
    elif case == "ties":                  # two predictions of equal IoU with GT 1
        gt, pred = np.zeros((16, 16), np.int32), np.zeros((16, 16), np.int16)
        gt[4:12, 4:12] = 1
        pred[4:12, 4:8], pred[4:12, 8:12], pred[0:2, 0:2] = 3, 2, 1
    elif case == "lowest_id_not_0":       # no background pixel in either map
        gt, pred = gt + 2, pred + 1
    return gt, pred


CASES = ["random", "gaps", "no_prediction", "no_gt", "every_iou_zero", "ties",
         "lowest_id_not_0"]


def _table(gt, pred, fg=None, max_gt=None, max_pred=None):
    """The twin's table of one image, with room past the largest ids."""
    return label_pairs(torch.from_numpy(pred[None]), torch.from_numpy(gt[None]),
                       int(gt.max()) + 1 if max_gt is None else max_gt,
                       int(pred.max()) + 3 if max_pred is None else max_pred,
                       None if fg is None else torch.from_numpy(fg[None])).numpy()[0]


def _bbbc_by_maps(mod, gt, pred):
    gt, pred = mod.remap_label(gt, by_size=False), mod.remap_label(pred, by_size=False)
    pq = mod.get_fast_pq(gt, pred, match_iou=0.5)
    return (mod.agg_jc_index(gt, pred), mod.pixel_f1(gt, pred), pq[0],
            [list(map(int, x)) for x in pq[1]])


@pytest.mark.parametrize("case", CASES + ["random_seed1", "random_seed2"])
def test_bbbc_scores_from_the_table_equal_the_map_functions(case):
    gt, pred = _pair(case.split("_seed")[0], seed=int(case[-1]) if "_seed" in case else 0)
    joint = mb.remap_table(_table(gt, pred))
    pq = mb.fast_pq_from_table(joint, match_iou=0.5)
    ours = (mb.agg_jc_index_from_table(joint), mb.pixel_f1_from_table(joint), pq[0],
            [list(map(int, x)) for x in pq[1]])
    assert ours == _bbbc_by_maps(mb, gt, pred) == _bbbc_by_maps(jax_bbbc, gt, pred)
    np.testing.assert_array_equal(
        joint, mb._contingency(mb.remap_label(gt), mb.remap_label(pred)))
    # the raw, uncompressed table: the map functions on the raw maps
    raw = mb._contingency(gt, pred)
    assert mb.agg_jc_index_from_table(raw) == jax_bbbc.agg_jc_index(gt, pred)


def test_the_every_iou_zero_quirk_and_ties_are_kept():
    gt, pred = _pair("every_iou_zero")
    # GT 1 takes prediction 3 (IoU 12/24 against 12/108 for prediction 2);
    # GT 2 takes prediction 2 (IoU 24/108); GT 3 overlaps nothing and uses
    # up prediction 1, unused, whose 50 pixels join the union; GT 4 overlaps
    # nothing with every prediction used: its union is its own 16 pixels
    joint = mb.remap_table(_table(gt, pred))
    assert mb.agg_jc_index_from_table(joint) == (12 + 24) / (
        (24 + 12 - 12) + (36 + 96 - 24) + (36 + 50) + 16)
    gt, pred = _pair("ties")
    joint = mb.remap_table(_table(gt, pred))
    # predictions 2 and 3 tie at IoU 0.5: the first, 2, is matched; 1 and 3
    # join the union unused
    assert mb.agg_jc_index_from_table(joint) == 32 / (64 + 4 + 32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_fg", [False, True], ids=["no_fg", "fg"])
def test_cvppp_scores_from_the_table_equal_the_map_functions(case, with_fg):
    gt, pred = _pair(case)
    fg = None
    seg = pred.astype(np.uint16)
    if with_fg:
        fg = (_blocks(np.random.RandomState(7), gt.shape, 1, 3) > 0)
        seg = seg * fg.astype(np.uint16)
    gt16 = gt.astype(np.uint16)
    joint = _table(gt, pred, fg).T
    ours = (mc.symmetric_best_dice_from_table(joint), mc.diff_fg_labels_from_table(joint))
    maps = (mc.SymmetricBestDice(seg, gt16), mc.DiffFGLabels(seg, gt16))
    assert ours == maps == (jax_cvppp.SymmetricBestDice(seg, gt16),
                            jax_cvppp.DiffFGLabels(seg, gt16))


@pytest.mark.parametrize("gt_dtype", [torch.int32, torch.int16, torch.uint16])
@pytest.mark.parametrize("with_fg", [False, True], ids=["no_fg", "fg"])
def test_the_twin_counts_every_pixel_once(gt_dtype, with_fg):
    rng = np.random.RandomState(3)
    labels = torch.from_numpy(_blocks(rng, (3 * 23, 31), 9, 3).astype(np.int16)).reshape(3, 23, 31)
    gt = torch.from_numpy(_blocks(rng, (3 * 23, 31), 6, 4).astype(np.int32)).reshape(3, 23, 31)
    fg = torch.from_numpy(rng.rand(3, 23, 31) > 0.4) if with_fg else None
    table = label_pairs(labels, gt.to(gt_dtype), 6, 9, fg)
    assert table.dtype == torch.int32 and table.shape == (3, 7, 10)
    assert table.sum(dim=(1, 2)).tolist() == [23 * 31] * 3
    for b in range(3):
        p = labels[b].long() * (fg[b] if with_fg else 1)
        want = mb._contingency(gt[b].numpy(), p.numpy())
        got = table[b].numpy()
        np.testing.assert_array_equal(got[:want.shape[0], :want.shape[1]], want)
        assert got.sum() == want.sum()
    # an id out of range is not counted
    short = label_pairs(labels, gt.to(gt_dtype), 5, 9, fg)
    assert (short.sum(dim=(1, 2)) < 23 * 31).all()


@pytest.mark.parametrize("bad", ["labels int32", "labels 2-D", "gt float", "gt shape",
                                 "fg float", "fg shape", "max_gt negative", "impl"])
def test_the_wrapper_refuses_what_the_kernel_cannot_take(bad):
    labels = torch.zeros(2, 5, 6, dtype=torch.int16)
    gt = torch.zeros(2, 5, 6, dtype=torch.int32)
    kw = {"max_gt": 3, "max_pred": 4, "fg": None}
    if bad == "labels int32":
        labels = labels.int()
    elif bad == "labels 2-D":
        labels = labels[0]
    elif bad == "gt float":
        gt = gt.float()
    elif bad == "gt shape":
        gt = gt[:, :4]
    elif bad == "fg float":
        kw["fg"] = torch.ones(2, 5, 6)
    elif bad == "fg shape":
        kw["fg"] = torch.ones(2, 5, 7, dtype=torch.uint8)
    elif bad == "max_gt negative":
        kw["max_gt"] = -1
    else:
        kw["impl"] = "kernel"
    with pytest.raises(ValueError):
        label_pairs(labels, gt, **kw)
    assert label_pairs_twin(torch.zeros(2, 5, 6, dtype=torch.int16),
                            torch.zeros(2, 5, 6, dtype=torch.int32), 0, 0).sum() == 60


def _with_fg(batches, seed=9):
    rng = np.random.RandomState(seed)
    for b in batches:
        b["fg"] = (rng.rand(*b["label"].shape) > 0.3).astype(np.int32)
    return batches


@pytest.mark.parametrize("protocol", ["test_bbbc", "eval_cvppp", "eval_cvppp_fg"])
def test_the_pipeline_scores_equal_the_map_functions_on_its_labels(protocol):
    """The scores of the pipeline's tables against the map-taking path of
    the parent on the same labels, in the same order."""
    dataset = "bbbc" if protocol == "test_bbbc" else "cvppp"
    batches = _padded(list(_batches(3, seed=11)))
    if protocol.endswith("_fg"):
        batches = _with_fg(batches)
    ev = Evaluator(_model(), top_k=4, dataset=dataset)
    got = getattr(ev, protocol.replace("_fg", ""))(batches)
    assert all(b["_label_pairs"].shape == (2, int(b["label"].max()) + 1, ev.num_queries + 1)
               for b in batches)
    ref_ev = Evaluator(_model(), top_k=4, dataset=dataset)
    per_image = []
    for batch in batches:
        labels = ref_ev.predict_labels(batch["image"])
        for b in range(int(batch.get("_num_valid", 2))):
            if dataset == "bbbc":
                gt = mb.remap_label(batch["label"][b], by_size=False)
                pred = mb.remap_label(labels[b], by_size=False)
                dq, _, pq = mb.get_fast_pq(gt, pred, match_iou=0.5)[0]
                per_image.append((mb.agg_jc_index(gt, pred), mb.pixel_f1(gt, pred), dq, pq))
            else:
                seg = labels[b].astype(np.uint16)
                if "fg" in batch:
                    seg = seg * (batch["fg"][b] > 0).astype(np.uint16)
                gt = batch["label"][b].astype(np.uint16)
                per_image.append((mc.SymmetricBestDice(seg, gt), abs(mc.DiffFGLabels(seg, gt))))
    if dataset == "bbbc":
        want = {}
        for name, v in zip(("AJI", "F1", "detF1", "PQ"), zip(*per_image)):
            want[name], want[f"{name}_std"] = float(np.mean(v)), float(np.std(v))
    else:
        sbd = dic = 0.0
        for a, d in per_image:
            sbd += a
            dic += d
        want = {"SBD": sbd / len(per_image), "absDiffFG": dic / len(per_image)}
    assert got == want


def test_a_gt_id_out_of_range_raises():
    batches = list(_batches(1, seed=12))
    batches[0]["label"][0, 0, 0] = -1
    with pytest.raises(ValueError, match="outside"):
        Evaluator(_model(), top_k=4, dataset="bbbc").test_bbbc(batches)
