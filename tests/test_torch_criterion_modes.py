"""The criterion's sampled point modes (``shared``, ``weighted``, ``topk``,
``exact``) against the JAX package's ``SetCriterion`` on the same outputs,
targets and uniform draws (the port takes JAX's, split from its keys as
``criterion.py:315-316, 363``, ``point_sample.py:168, 173, 259`` and
``matcher.py:59, 113`` split them); then the reference estimator's train
step (``exact``, ``CANDIDATE_RATIO`` 3, ``EXACT_TARGETS``, f32 sampling,
``UPSAMPLE2X``) against JAX's ``make_train_step``.

Tolerances: the criterion at sample_dtype float32, every loss and every
matching cost at rel 1e-5 (f32 on both sides, reductions in another
order); the composed train step at ``tests/test_torch_train_step.py``'s
loss and gradient tolerances (the differences pass through the model).
Matching is compared by cost, and the loss dicts agree because the
optimum is unique on these continuous costs.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.config import get_cfg_defaults
from pctrans_tpu.data.targets import targets_from_labels as jax_targets
from pctrans_tpu.engine.solver import build_optimizer as jax_build_optimizer
from pctrans_tpu.engine.state import TrainState
from pctrans_tpu.engine.state import make_train_step as jax_make_train_step
from pctrans_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from pctrans_tpu.losses.criterion import SetCriterion as JaxCriterion
from pctrans_tpu.losses.matcher import _pair_costs as jax_pair_costs
from pctrans_tpu.losses.matcher import point_matcher_indices as jax_point_matcher
from pctrans_tpu.models import ModelConfig as JaxConfig
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_tpu.ops.point_sample import point_sample as jax_point_sample
from pctrans_tpu.ops.point_sample import sample_label_onehot as jax_onehot
from pctrans_torch.config import ModelConfig
from pctrans_torch.data.targets import targets_from_labels
from pctrans_torch.engine.solver import (build_lr_scheduler, build_optimizer,
                                         build_solver_config, clip_gradients)
from pctrans_torch.engine.train_step import make_train_step
from pctrans_torch.losses.criterion import (CriterionConfig, SetCriterion,
                                            build_criterion_config)
from pctrans_torch.models import PCTransModel
from pctrans_torch.weights import load_flax_variables
from test_torch_criterion import _labels, _outputs, _t
from test_torch_slice import _randomize
from test_torch_train_step import (BATCH, G, GRAD_REL_FRO, HW, LOSS_ATOL, LOSS_RTOL,
                                   TINY, _as_torch, _batch, _recording)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
MODES = ["shared", "weighted", "topk", "exact"]


def jax_draws(rng, c, B, G, Q):
    """The uniform draws of the JAX criterion under ``rng``, in the port's
    :meth:`SetCriterion.draws` layout."""
    L = c.dec_layers
    k_match, k_points, k_reid = jax.random.split(rng, 3)
    reid = np.stack([np.asarray(jax.random.uniform(k, (G, Q)))
                     for k in jax.random.split(k_reid, B)])
    match = np.stack([np.stack([np.asarray(jax.random.uniform(kb, (1, c.num_points, 2)))
                                for kb in jax.random.split(kl, B)])
                      for kl in jax.random.split(k_match, L)])
    draws = {"match": match}
    points, fill = [], []
    for k in jax.random.split(k_points, L):
        if c.point_select == "shared":
            points.append(jax.random.uniform(k, (2, B, int(c.num_points * c.candidate_ratio))))
        elif c.point_select == "weighted":
            points.append(jax.random.uniform(k, (2, B * G, int(c.num_points * c.oversample_ratio))))
        else:
            k1, k2 = jax.random.split(k)
            points.append(jax.random.uniform(k1, (2, B * G, int(c.num_points * c.oversample_ratio))))
            num_random = c.num_points - int(c.importance_sample_ratio * c.num_points)
            fill.append(jax.random.uniform(k2, (B * G, num_random, 2)))
    draws["points"] = np.stack([np.asarray(p) for p in points])
    if fill:
        draws["fill"] = np.stack([np.asarray(f) for f in fill])
    return reid, draws


def jax_match_costs(stacked, seg, match, G):
    """The JAX matcher's [L, B, Q, G] costs at its points (``matcher.py:
    48-71``): all Q masks point-sampled as channels, targets through the
    label map."""
    L, B = stacked.shape[:2]
    out = []
    for l in range(L):
        row = []
        for b in range(B):
            coords = jnp.asarray(match[l, b])                       # [1, P, 2]
            o = jax_point_sample(jnp.asarray(stacked[l, b])[None], coords)[0]
            t = jax_onehot(jnp.asarray(seg[b])[None], coords, G)[0]
            row.append(np.asarray(jax_pair_costs(o, t.astype(o.dtype), 5.0, 5.0)))
        out.append(np.stack(row))
    return np.stack(out)


def _mode_kw(mode, L):
    kw = dict(num_points=48, dec_layers=L, sample_dtype="float32", point_select=mode)
    if mode == "exact":
        kw.update(exact_targets=True, candidate_ratio=3.0)
    if mode == "shared":
        kw.update(candidate_ratio=2.0)
    return kw


@pytest.mark.parametrize("mode", MODES)
def test_criterion_mode_matches_jax(mode):
    """The matching costs, the matched total cost of every lane, and the
    whole loss dict and total at JAX's assignment and draws; f32 sampling.
    Two ground-truth slots that no matcher point hits have equal cost
    columns, so their queries may be swapped at equal cost (ROADMAP.md
    §C.2): the losses are compared at JAX's assignment."""
    B, Q, L, G_, C = 2, 12, 4, 6, 16
    labels = _labels(20, HW=(48, 40))
    outs = _outputs(np.random.RandomState(20), B, Q, L, 12, 10, C)
    kw = _mode_kw(mode, L)
    rng = jax.random.key(21)
    jouts = jax.tree_util.tree_map(jnp.asarray, outs)
    jtargets = jax_targets(jnp.asarray(labels), G_)
    jcrit = JaxCriterion(JaxCriterionConfig(**kw))
    ref_total, ref = jax.jit(jcrit.__call__)(rng, jouts, jtargets)
    reid, draws = jax_draws(rng, jcrit.cfg, B, G_, Q)
    stacked = np.stack(outs["aux_masks"] + [outs["pred_masks"]])
    k_match = jax.random.split(rng, 3)[0]
    j_idx = np.stack([np.asarray(jax_point_matcher(
        k, jnp.asarray(stacked[l]), jtargets["seg"], jtargets["valid"], kw["num_points"]))
        for l, k in enumerate(jax.random.split(k_match, L))])

    crit = SetCriterion(CriterionConfig(**kw))
    touts = {k: [_t(a) for a in v] if isinstance(v, list) else _t(v)
             for k, v in outs.items()}
    targets = targets_from_labels(_t(labels), G_)
    tdraws = {k: _t(v) for k, v in draws.items()}
    idx, costs, _ = crit.match_with_costs(_t(stacked), targets, tdraws)
    ref_costs = jax_match_costs(stacked, targets["seg"].numpy(), draws["match"], G_)
    np.testing.assert_allclose(costs.numpy(), ref_costs, rtol=RTOL, atol=ATOL)
    valid = targets["valid"].numpy()
    for l in range(L):
        for b in range(B):
            cols = np.flatnonzero(valid[b])
            np.testing.assert_allclose(ref_costs[l, b, idx[l, b, cols].numpy(), cols].sum(),
                                       ref_costs[l, b, j_idx[l, b, cols], cols].sum(),
                                       rtol=RTOL)

    ours_total, ours, _ = crit(touts, targets, _t(reid), tdraws,
                               indices=torch.from_numpy(j_idx).long())
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(ours_total), float(ref_total), rtol=RTOL)


def test_draws_have_jax_shapes():
    B, Q, G_ = 2, 12, 6
    for mode in MODES + ["dense"]:
        kw = _mode_kw(mode, 4) if mode != "dense" else dict(num_points=48, dec_layers=4)
        jcfg = JaxCriterionConfig(**kw)
        reid, ref = jax_draws(jax.random.key(0), jcfg, B, G_, Q)
        t_reid, ours = SetCriterion(CriterionConfig(**kw)).draws(
            B, G_, Q, torch.Generator().manual_seed(0))
        assert t_reid.shape == reid.shape
        if mode == "dense":
            assert ours == {}
            continue
        assert {k: tuple(v.shape) for k, v in ours.items()} == \
            {k: v.shape for k, v in ref.items()}


def test_build_criterion_config_maps_every_point_mode():
    cfg = get_cfg_defaults()
    tr = cfg.MODEL.MASK_FORMER.TPU_RECIPE
    for mode in MODES + ["dense"]:
        tr.POINT_SELECT = mode
        tr.CANDIDATE_RATIO, tr.EXACT_TARGETS = 3.0, True
        c = build_criterion_config(cfg)
        assert (c.point_select, c.candidate_ratio, c.exact_targets) == (mode, 3.0, True)
    tr.POINT_SELECT = "bogus"
    with pytest.raises(ValueError, match="point_select"):
        build_criterion_config(cfg)


# ------------------------------------------------- the reference estimator
REF_CRIT = dict(num_points=64, dec_layers=4, sample_dtype="float32",
                point_select="exact", exact_targets=True, candidate_ratio=3.0)


@pytest.fixture(scope="module")
def ref_run():
    """One train step of the tiny model (GN heads, UPSAMPLE2X) under the
    reference estimator in both packages, with JAX's draws; the JAX
    optimizer records its gradients."""
    kw = dict(TINY, head_norm="GN", upsample2x=True)
    jcfg = JaxConfig(**kw)
    jmodel = JaxModel(config=jcfg, train=True)
    batch = _batch(3)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, *HW, 3)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c,
                               np.random.RandomState(1))
                 for c, t in variables.items()}
    params = variables["params"]
    cfg = get_cfg_defaults()
    tx = _recording(jax_build_optimizer(cfg, params))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       frozen=variables.get("frozen", {}),
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state=tx.init(params))
    jcrit = JaxCriterion(JaxCriterionConfig(**REF_CRIT))
    step = jax.jit(jax_make_train_step(jcfg, jcrit, tx, max_instances=G))
    rng_key = jax.random.key(0)
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              rng_key)
    reid, draws = jax_draws(jax.random.fold_in(rng_key, 0), jcrit.cfg, BATCH, G,
                            TINY["num_queries"])

    model = PCTransModel(ModelConfig(**kw))
    load_flax_variables(model, variables)
    initial = copy.deepcopy(model)
    solver = build_solver_config(cfg)
    opt = build_optimizer(model, solver)
    train_step = make_train_step(model, SetCriterion(CriterionConfig(**REF_CRIT)), opt,
                                 build_lr_scheduler(opt, solver), G, solver=solver)
    t_metrics = train_step(batch, reid_uniform=_t(reid),
                           point_draws={k: _t(v) for k, v in draws.items()})
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state[1])
    return types.SimpleNamespace(
        model=model, initial=initial, solver=solver, params=params, j_grad_tree=grads,
        j_grads=_as_torch(grads, params),
        j_metrics=jax.tree_util.tree_map(np.asarray, metrics),
        t_metrics={k: float(v) for k, v in t_metrics.items()})


def test_reference_estimator_step_losses_match_jax(ref_run):
    assert set(ref_run.t_metrics) == set(ref_run.j_metrics)
    for k, v in ref_run.j_metrics.items():
        np.testing.assert_allclose(ref_run.t_metrics[k], v, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


# On this batch the JAX package's own f32 CPU gradient lies up to 1.6e-3
# (rel-Fro) from the exact gradient in the encoder's FFN and input
# projections, whatever the point mode (2.8e-3 in the dense mode), while the
# port's f32 gradient lies within 4e-6 of the same model run in f64
# (ROADMAP.md §C.12); 3e-3 covers JAX's own error.
REF_GRAD_REL_FRO = 3e-3


def test_reference_estimator_step_gradients_match_jax(ref_run):
    """The step's gradients (what its optimizer update is made of; the
    optimizers themselves are held against optax in
    ``tests/test_torch_solver.py``), per tensor where the gradient is not
    zero in exact arithmetic."""
    largest = max(float(g.norm()) for g in ref_run.j_grads.values())
    errors = {}
    for name, p in ref_run.model.named_parameters():
        ref = ref_run.j_grads[name]
        if float(ref.norm()) <= 1e-4 * largest:
            assert float(p.grad.norm()) <= 1e-4 * largest, name
            continue
        errors[name] = float((p.grad - ref).norm() / ref.norm())
    assert len(errors) > 0.8 * len(ref_run.j_grads)
    assert max(errors.values()) <= REF_GRAD_REL_FRO, max(errors.items(), key=lambda e: e[1])
    # outside the pixel decoder's encoder input path, the composed tests' bound
    rest = {n: e for n, e in errors.items() if not n.startswith("pixel_decoder.")}
    assert rest and max(rest.values()) <= GRAD_REL_FRO, max(rest.items(), key=lambda e: e[1])


def test_reference_estimator_update_on_jax_gradients_matches_optax(ref_run):
    """One optimizer update of the step: the port's AdamW and scheduler (the
    step's solver, clipping included) fed the JAX step's gradients give
    optax's update, both in f64 as in ``tests/test_torch_train_step.py``
    (an f32 ``new - old`` at BASE_LR * WARMUP_FACTOR is mostly rounding)."""
    cfg = get_cfg_defaults()
    with jax.enable_x64(True):
        p64, g64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (ref_run.params, ref_run.j_grad_tree))
        tx = jax_build_optimizer(cfg, p64)
        updates, _ = tx.update(g64, tx.init(p64), p64)
        ref = _as_torch(jax.tree_util.tree_map(np.asarray, updates), ref_run.params)
    model = copy.deepcopy(ref_run.initial).double()
    opt = build_optimizer(model, ref_run.solver)
    sched = build_lr_scheduler(opt, ref_run.solver)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = ref_run.j_grads[n].double()
    clip_gradients(model.parameters(), ref_run.solver)
    opt.step()
    sched.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[n]).numpy(), ref[n].numpy(),
                                   rtol=1e-5, atol=1e-15, err_msg=n)
