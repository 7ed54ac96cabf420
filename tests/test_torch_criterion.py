"""The port's criterion pieces against the JAX package's on the same numpy
inputs: targets, label sampling, nearest resize, the bisection threshold,
matcher costs, the host LAP, the discriminative, re-id and focal losses, and
the whole dense ``SetCriterion`` dict.

Discrete results (targets, one-hot samples, thresholds, indices) must be
equal.  Losses are f32 on both sides with reductions in another order:
rtol 1e-5 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.data.targets import targets_from_labels as jax_targets
from pctrans_tpu.losses.contrast import (cosine_similarity_matrix as jax_cos,
                                         pairwise_mask_dice as jax_dice,
                                         reid_losses_one_image)
from pctrans_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from pctrans_tpu.losses.criterion import SetCriterion as JaxCriterion
from pctrans_tpu.losses.discriminative import discriminative_loss as jax_disc
from pctrans_tpu.losses.matcher import _pair_costs as jax_pair_costs
from pctrans_tpu.ops.lap import match_padded as jax_match_padded
from pctrans_tpu.ops.point_sample import kth_largest_threshold as jax_kth
from pctrans_tpu.ops.point_sample import sample_label_onehot_grid as jax_onehot_grid
from pctrans_tpu.ops.resize import resize_nearest_torch as jax_nearest
from pctrans_torch.data.synthetic import make_blob_image
from pctrans_torch.data.targets import targets_from_labels
from pctrans_torch.losses.contrast import (cosine_similarity_matrix,
                                           pairwise_mask_dice, reid_losses)
from pctrans_torch.losses.criterion import CriterionConfig, SetCriterion
from pctrans_torch.losses.discriminative import discriminative_loss
from pctrans_torch.losses.matcher import pair_costs
from pctrans_torch.ops.lap import match_padded
from pctrans_torch.ops.point_sample import (kth_largest_threshold,
                                            sample_label_onehot_grid)
from pctrans_torch.ops.resize import resize_nearest_torch

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _labels(seed, B=2, HW=(48, 40), n=(3, 6)):
    rng = np.random.RandomState(seed)
    return np.stack([make_blob_image(rng, HW, n_instances=n)[1] for _ in range(B)])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_targets_from_labels_equal_jax():
    labels = _labels(0)
    labels[0, :3, :3] = 9                       # an id above G: dropped from seg
    ref = jax_targets(jnp.asarray(labels), 8)
    ours = targets_from_labels(_t(labels), 8)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("hw", [(12, 10), (24, 20), (6, 5),   # strided path
                                (13, 9), (20, 17)])           # corner gathers
def test_sample_label_onehot_grid_equal_jax(hw):
    seg = _labels(1)
    ref = np.asarray(jax_onehot_grid(jnp.asarray(seg), hw, 8))
    ours = sample_label_onehot_grid(_t(seg), hw, 8).numpy()
    assert ours.shape == (2, 8) + hw
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size", [(12, 10), (24, 8), (13, 9), (31, 17)])
def test_resize_nearest_torch_equal_jax(size):
    seg = _labels(2)
    np.testing.assert_array_equal(resize_nearest_torch(_t(seg), size).numpy(),
                                  np.asarray(jax_nearest(jnp.asarray(seg), size)))


@pytest.mark.parametrize("k", [1, 37, 64, 255])
def test_kth_largest_threshold_equal_jax(k):
    rng = np.random.RandomState(k)
    x = -np.abs(rng.randn(3, 4, 256) * 4).astype(np.float32)
    x[0, 0, :40] = x[0, 0, 0]                     # ties
    ref = np.asarray(jax_kth(jnp.asarray(x), k))
    ours = kth_largest_threshold(_t(x), k).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(_t(x).ge(_t(ours)).numpy(), x >= ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_costs_match_jax(dtype):
    """In bf16 both sides round the elementwise steps to bf16 (the sigmoid's
    last division excepted, which XLA keeps in f32) and take the products
    in f32, so the costs agree to f32 summation order."""
    rng = np.random.RandomState(3)
    out = (rng.randn(3, 10, 256) * 3).astype(np.float32)
    tgt = (rng.rand(3, 6, 256) < 0.3).astype(np.float32)
    tgt[:, :, ::3] *= 0.5                         # bilinear fractions
    jd = jnp.dtype(dtype)
    ref = np.stack([np.asarray(jax.jit(jax_pair_costs, static_argnums=(2, 3))(
        jnp.asarray(o).astype(jd), jnp.asarray(t).astype(jd), 5.0, 5.0))
        for o, t in zip(out, tgt)])
    td = getattr(torch, dtype)
    ours = pair_costs(_t(out).to(td), _t(tgt).to(td), 5.0, 5.0)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_match_padded_equals_jax_without_ties():
    rng = np.random.RandomState(4)
    cost = rng.rand(5, 10, 6).astype(np.float32)
    valid = rng.rand(5, 6) < 0.7
    valid[:, 0] = True
    valid[4] = False                              # no instance at all
    ref = np.stack([np.asarray(jax_match_padded(jnp.asarray(c), jnp.asarray(v)))
                    for c, v in zip(cost, valid)])
    ours = match_padded(_t(cost), _t(valid)).numpy()
    np.testing.assert_array_equal(ours[valid], ref[valid])
    assert ((ours >= 0) & (ours < 10)).all()
    for n in range(5):                            # one query per valid slot
        assert len(set(ours[n][valid[n]])) == valid[n].sum()


def test_match_padded_total_cost_equals_jax_with_ties():
    rng = np.random.RandomState(5)
    cost = rng.randint(0, 3, (4, 8, 5)).astype(np.float32)   # many ties
    valid = np.ones((4, 5), bool)
    valid[1, 3:] = False
    ours = match_padded(_t(cost), _t(valid)).numpy()
    for n in range(4):
        ref = np.asarray(jax_match_padded(jnp.asarray(cost[n]), jnp.asarray(valid[n])))
        cols = np.flatnonzero(valid[n])
        assert cost[n, ours[n, cols], cols].sum() == cost[n, ref[cols], cols].sum()


def _emb_case(seed):
    rng = np.random.RandomState(seed)
    seg = _labels(seed, HW=(48, 40))
    seg[1] = 0
    seg[1, 20, 17] = 1                            # a single-pixel instance
    seg[1, 4:8, 4:12] = 2
    emb = rng.randn(2, 12, 10, 8).astype(np.float32)
    return emb, seg


def test_discriminative_loss_values_and_grads_match_jax():
    emb, seg = _emb_case(6)
    ref, ref_g = jax.value_and_grad(jax_disc)(jnp.asarray(emb), jnp.asarray(seg), 8)
    e = _t(emb).requires_grad_()
    ours = discriminative_loss(e, _t(seg), 8)
    ours.backward()
    assert torch.isfinite(e.grad).all()
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ref_g), rtol=1e-4, atol=1e-7)


def _reid_case(seed, B=2, Q=12, G=5, C=16):
    rng = np.random.RandomState(seed)
    query = rng.randn(B, Q, C).astype(np.float32)
    masks = (rng.randn(B, Q, 9, 7) * 3).astype(np.float32)
    q4g = np.stack([rng.permutation(Q)[:G] for _ in range(B)])
    valid = np.ones((B, G), bool)
    valid[1, 3:] = False
    return query, masks, q4g, valid


def test_reid_losses_match_jax_with_its_draws():
    query, masks, q4g, valid = _reid_case(7)
    B, Q = query.shape[:2]
    G = q4g.shape[1]
    keys = jax.random.split(jax.random.key(3), B)
    draws = np.stack([np.asarray(jax.random.uniform(k, (G, Q))) for k in keys])
    emb = jax.vmap(jax_cos)(jnp.asarray(query))
    dice = jax.vmap(jax_dice)(jnp.asarray(masks))
    ref = jax.vmap(reid_losses_one_image)(keys, jnp.asarray(query), emb, dice,
                                          jnp.asarray(q4g), jnp.asarray(valid))
    t_emb = cosine_similarity_matrix(_t(query))
    t_dice = pairwise_mask_dice(_t(masks))
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(emb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_dice.numpy(), np.asarray(dice), rtol=RTOL, atol=ATOL)
    ours = reid_losses(_t(query), t_emb, t_dice, _t(q4g).long(), _t(valid), _t(draws))
    names = ("contrast_q", "aux_q", "contrast_m", "n_items")
    for name, a, b in zip(names, ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert int(ours[3].sum()) > 0


def test_focal_sem_loss_matches_jax():
    rng = np.random.RandomState(8)
    logits = (rng.randn(2, 12, 10, 1) * 2).astype(np.float32)
    fg = (_labels(8) > 0).astype(np.float32)
    ref = JaxCriterion(JaxCriterionConfig())._sem_loss(jnp.asarray(logits), jnp.asarray(fg))
    ours = SetCriterion(CriterionConfig()).sem_loss(_t(logits), _t(fg))
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)


def _outputs(rng, B, Q, L, h, w, C):
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    return {
        "aux_masks": [f(B, Q, h, w, scale=3.0) for _ in range(L - 1)],
        "pred_masks": f(B, Q, h, w, scale=3.0),
        "aux_reference_points": [rng.rand(B, Q, 2).astype(np.float32) for _ in range(L - 2)],
        "reference_points": rng.rand(B, Q, 2).astype(np.float32),
        "query_emb": f(B, Q, C),
        "sem_mask": f(B, h, w, 1, scale=2.0),
        "mask_features": f(B, h, w, C),
    }


def test_set_criterion_dict_matches_jax():
    """The whole dense criterion at sample_dtype float32 on random outputs,
    with JAX's re-id draws fed to the port."""
    B, Q, L, G, C = 2, 12, 4, 6, 16
    labels = _labels(9, HW=(48, 40))
    outs = _outputs(np.random.RandomState(9), B, Q, L, 12, 10, C)
    kw = dict(num_points=120, dec_layers=L, sample_dtype="float32")
    rng = jax.random.key(5)
    jouts = jax.tree_util.tree_map(jnp.asarray, outs)
    ref_total, ref = jax.jit(JaxCriterion(JaxCriterionConfig(**kw)).__call__)(
        rng, jouts, jax_targets(jnp.asarray(labels), G))
    _, _, k_reid = jax.random.split(rng, 3)
    draws = np.stack([np.asarray(jax.random.uniform(k, (G, Q)))
                      for k in jax.random.split(k_reid, B)])
    touts = {k: [_t(a) for a in v] if isinstance(v, list) else _t(v)
             for k, v in outs.items()}
    total, ours, indices = SetCriterion(CriterionConfig(**kw))(
        touts, targets_from_labels(_t(labels), G), _t(draws))
    assert indices.shape == (L, B, G)
    assert set(ours) == set(ref)              # jit returns the keys sorted
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=RTOL)


def test_set_criterion_gradients_stay_finite_at_saturated_logits():
    """Mask and sem logits of +-200 (random full-width weights reach them):
    ``exp(-x)`` overflows in f32, so a sigmoid differentiated as
    ``1 / (1 + exp(-x))`` would give NaN gradients; the losses use a
    stable sigmoid and softplus."""
    B, Q, L, G, C = 2, 12, 4, 6, 16
    labels = _labels(10, HW=(48, 40))
    outs = _outputs(np.random.RandomState(10), B, Q, L, 12, 10, C)
    outs["pred_masks"][:, :, :6] = 200.0
    outs["pred_masks"][:, :, 6:] = -200.0
    outs["sem_mask"][:, :6] = -200.0
    touts = {k: [_t(a).requires_grad_() for a in v] if isinstance(v, list)
             else _t(v).requires_grad_() for k, v in outs.items()}
    total, _, _ = SetCriterion(CriterionConfig(num_points=120, dec_layers=L))(
        touts, targets_from_labels(_t(labels), G), torch.rand(B, G, Q))
    total.backward()
    for k in ("pred_masks", "sem_mask", "query_emb", "mask_features"):
        assert torch.isfinite(touts[k].grad).all(), k
