"""The port's Swin backbone and PCTrans over it against the benchmark's
plain reference (``portbench/reference/swin.py``, composed with the
reference's pixel decoder and decoder in ``reference/model_swin.py``), f32
on the CPU, on the reference's seeded weights loaded into the port, at a
small Swin-L shape: embed 32 with heads (1, 2, 4, 8), so every head is 32
wide as in Swin-L, depths (2, 2, 18, 2), window 12.  At 112x104 the token
maps are 28x26 (padded to 36x36, shifted), 14x13 (padded to 24x24,
shifted), 7x7 and 4x4 (windows clamped to the map); at 96x96 they are
24x24 (whole windows, shifted), 12x12, 6x6 and 3x3 (clamped).

* the backbone's four outputs;
* the whole forward's mask features and first masks;
* one training step's total loss and every gradient, at drop path 0 and
  at the recipe's 0.3 (both sides draw the criterion's uniforms, then the
  drop path's, from one generator each, seeded alike).
"""

import pytest
import torch

from pctrans_torch.config import ModelConfig
from pctrans_torch.data.targets import targets_from_labels
from pctrans_torch.losses.criterion import CriterionConfig, SetCriterion
from pctrans_torch.models import PCTransModel
from portbench.reference import criterion as ref_criterion
from portbench.reference.model_swin import PCTransSwinReference, SwinModelConfig
from portbench.reference.targets import targets_from_labels as ref_targets

torch.set_num_threads(1)

SIZES = dict(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10, nheads=4,
             dim_feedforward=64, enc_layers=1, dec_layers=3, head_norm="GN",
             backbone_name="D2SwinTransformer", swin_embed_dim=32,
             swin_depths=(2, 2, 18, 2), swin_num_heads=(1, 2, 4, 8), swin_window_size=12,
             swin_drop_path=0.0, pixel_std=(255.0, 255.0, 255.0))
# the CVPPP recipe's criterion (portbench/configs/cvppp-swinl.json) at the
# small decoder's depth, sampling in f32
CRITERION = dict(num_points=256, oversample_ratio=3.0, importance_sample_ratio=0.75,
                 mask_weight=5.0, dice_weight=5.0, refpoints_weight=5.0,
                 reid_query_weight=2.0, reid_mask_weight=2.0, sem_weight=5.0,
                 emb_weight=2.0, sem_loss_on=True, dec_layers=4, sample_dtype="float32",
                 exact_targets=False, point_select="dense", candidate_ratio=1.0)
MAX_INSTANCES = 8
# the same f32 operations in the same order on both sides; a little room
# for an op whose CPU kernel sums in another order at another size
RTOL = 1e-5


def pair(drop_path=0.0):
    sizes = dict(SIZES, swin_drop_path=drop_path)
    ref = PCTransSwinReference(SwinModelConfig(**sizes),
                               generator=torch.Generator().manual_seed(0))
    port = PCTransModel(ModelConfig(**sizes))
    port.load_state_dict(ref.state_dict(), strict=True)
    return port, ref


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def images(hw, seed=1, batch=2):
    return torch.rand((batch,) + hw + (3,), generator=torch.Generator().manual_seed(seed)) * 255


@pytest.mark.parametrize("hw", [(112, 104), (96, 96)])
def test_backbone_outputs_equal_the_reference(hw):
    port, ref = pair()
    x = images(hw).permute(0, 3, 1, 2) / 255
    with torch.no_grad():
        got, want = port.backbone.eval()(x), ref.backbone.eval()(x)
    assert list(got) == ["res2", "res3", "res4", "res5"] == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        assert rel(got[k], want[k]) <= RTOL, k


@pytest.mark.parametrize("hw", [(112, 104), (96, 96)])
def test_forward_features_and_first_masks_equal_the_reference(hw):
    port, ref = pair()
    x = images(hw)
    with torch.no_grad():
        got, want = port.eval()(x), ref.eval()(x)
    assert rel(got["mask_features"], want["mask_features"]) <= RTOL
    assert rel(got["aux_masks"][0], want["aux_masks"][0]) <= RTOL
    assert rel(got["pred_masks"], want["pred_masks"]) <= RTOL


def labels(hw, seed=2, batch=2):
    g = torch.Generator().manual_seed(seed)
    out = torch.zeros((batch,) + hw, dtype=torch.int32)
    for b in range(batch):
        for i in range(1, 5):
            y, x = torch.randint(0, hw[0] - 24, (2,), generator=g).tolist()
            out[b, y:y + 24, x:x + 20] = i
    return out


@pytest.mark.parametrize("drop_path", [0.0, 0.3])
def test_train_step_loss_and_gradients_equal_the_reference(drop_path):
    hw = (112, 104)
    port, ref = pair(drop_path)
    x, lab = images(hw), labels(hw)
    out = {}
    for name, model, criterion, targets in (
            ("port", port, SetCriterion(CriterionConfig(**CRITERION)), targets_from_labels),
            ("ref", ref, ref_criterion.SetCriterion(ref_criterion.CriterionConfig(**CRITERION)),
             ref_targets)):
        model.train()
        gen = torch.Generator().manual_seed(42)
        reid, drawn = criterion.draws(2, MAX_INSTANCES, SIZES["num_queries"], gen, "cpu")
        total, _, _ = criterion(model(x, generator=gen), targets(lab, MAX_INSTANCES), reid,
                                drawn or None)
        total.backward()
        out[name] = (float(total.detach()), {n: p.grad for n, p in model.named_parameters()
                                    if p.grad is not None})
    (loss_p, grads_p), (loss_r, grads_r) = out["port"], out["ref"]
    assert abs(loss_p - loss_r) <= RTOL * abs(loss_r)
    assert sorted(grads_p) == sorted(grads_r)
    assert any(n.startswith("backbone.blocks.2.17.") for n in grads_r)
    norms = {n: float(g.norm()) for n, g in grads_r.items()}
    floor = 1e-3 * sorted(norms.values())[len(norms) // 2]
    for n, g in grads_r.items():
        # a gradient near 0 in exact arithmetic (a key's bias under softmax)
        # holds rounding noise only: held to a thousandth of the median leaf
        err = float((grads_p[n].double() - g.double()).norm())
        assert err <= RTOL * max(norms[n], floor) * 10, n
