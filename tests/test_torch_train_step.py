"""The port's train step against the JAX package's ``make_train_step`` on the
tiny config of ``tests/test_train.py`` (depth-14 backbone, 1 encoder and 3
decoder layers, 10 queries, ``CriterionConfig(num_points=256,
dec_layers=4)``) at 64x64, batch 2, with the same weights, batch and re-id
draws; plus the solver, the BatchNorm repair and the eval-after-train
repair.

One jitted JAX step per head norm (SyncBN, GN) is shared by the tests of
that norm.  Its optimizer is the JAX package's AdamW wrapped so that the
state also records the step's gradients and updates.  Weights are
randomised as ``tests/test_torch_slice.py`` does, which makes the sampling
offsets nonzero: samples leave the integer pixel grid, where the JAX CPU
path's hat-matmul gradient and the port's twin agree.
"""

import copy
import dataclasses
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pctrans_tpu.config import get_cfg_defaults, load_cfg
from pctrans_tpu.data.targets import targets_from_labels as jax_targets
from pctrans_tpu.engine.solver import _is_norm_or_bias_path, build_lr_schedule
from pctrans_tpu.engine.solver import build_optimizer as jax_build_optimizer
from pctrans_tpu.engine.state import TrainState
from pctrans_tpu.engine.state import make_train_step as jax_make_train_step
from pctrans_tpu.losses import CriterionConfig as JaxCriterionConfig
from pctrans_tpu.losses import SetCriterion as JaxCriterion
from pctrans_tpu.losses import build_criterion
from pctrans_tpu.losses.matcher import dense_matcher_indices as jax_dense_matcher
from pctrans_tpu.models import ModelConfig as JaxConfig
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_tpu.models.layers import ConvNorm as JaxConvNorm
from pctrans_tpu.ops.point_sample import sample_label_onehot_grid as jax_onehot_grid
from pctrans_torch.config import ModelConfig
from pctrans_torch.data.synthetic import make_blob_image
from pctrans_torch.engine.evaluator import Evaluator
from pctrans_torch.engine.solver import (CVPPP_SOLVER, build_lr_scheduler,
                                         build_optimizer, build_solver_config,
                                         decayed_parameter_names,
                                         warmup_poly_factor)
from pctrans_torch.engine.train_step import make_train_step
from pctrans_torch.losses.criterion import (CVPPP_CRITERION, CriterionConfig,
                                            SetCriterion, build_criterion_config)
from pctrans_torch.models import PCTransModel
from pctrans_torch.models.layers import ConvNorm
from pctrans_torch.weights import _flatten, _to_torch, load_flax_variables, torch_key
from test_torch_slice import _randomize

torch.set_num_threads(1)

TINY = dict(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10, nheads=4,
            dim_feedforward=64, enc_layers=1, dec_layers=3, backbone_depth=14)
CRIT = dict(num_points=256, dec_layers=4)
HW, BATCH, G = (64, 64), 2, 8
# f32 on both sides; the JAX CPU path samples ms-deform with the hat-matmul
# and the twin with a 4-corner gather, norms compute their statistics in
# another order, and the differences pass through 3 decoder layers and the
# criterion's reductions.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GRAD_REL_FRO = 1e-3
STATS_RTOL = 1e-5


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    items = [make_blob_image(rng, HW, n_instances=(2, 4)) for _ in range(BATCH)]
    return {"image": np.stack([i for i, _ in items]),
            "label": np.stack([l for _, l in items])}


def _recording(tx):
    """``tx`` whose state also keeps the last gradients."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None, **extra):
        updates, inner = tx.update(grads, state[0], params, **extra)
        return updates, (inner, grads)

    return optax.GradientTransformationExtraArgs(init, update)


def _as_torch(tree, params):
    """flax param-shaped numpy tree -> {torch name: tensor}."""
    return {torch_key("params", path, params): _to_torch(a, path[-1])
            for path, a in _flatten(tree)}


def _reid_draws(rng_key, num_queries):
    """The uniform draws of the JAX criterion's re-id negatives at step 0
    (``state.py:74``, ``criterion.py:315, 406``)."""
    step_rng = jax.random.fold_in(rng_key, 0)
    _, _, k_reid = jax.random.split(step_rng, 3)
    keys = jax.random.split(k_reid, BATCH)
    return np.stack([np.asarray(jax.random.uniform(k, (G, num_queries)))
                     for k in keys])


@pytest.fixture(scope="module", params=["SyncBN", "GN"])
def run(request):
    kw = dict(TINY, head_norm=request.param)
    jcfg = JaxConfig(**kw)
    jmodel = JaxModel(config=jcfg, train=True)
    batch = _batch()
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
    jcrit = JaxCriterion(JaxCriterionConfig(**CRIT))
    step = jax.jit(jax_make_train_step(jcfg, jcrit, tx, max_instances=G))
    rng_key = jax.random.key(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, metrics = step(state, jbatch, rng_key)

    @jax.jit
    def jax_indices(variables, images, labels):
        out, _ = jmodel.apply(variables, images, mutable=["batch_stats"])
        stacked = jnp.stack(out["aux_masks"] + [out["pred_masks"]])
        L, _, Q, h, w = stacked.shape
        tgt = jax_targets(labels, G)
        dense = jax_onehot_grid(tgt["seg"], (h, w), G).reshape(BATCH, G, h * w)
        lanes = jnp.moveaxis(stacked.astype(jnp.bfloat16), 0, 1)
        idx = jax_dense_matcher(
            lanes.reshape(BATCH * L, Q, h, w),
            jnp.broadcast_to(dense[:, None], (BATCH, L, G, h * w)).reshape(BATCH * L, G, h * w),
            jnp.broadcast_to(tgt["valid"][:, None], (BATCH, L, G)).reshape(BATCH * L, G))
        return idx.reshape(BATCH, L, G).swapaxes(0, 1), tgt["valid"]

    j_idx, valid = jax_indices(variables, jbatch["image"], jbatch["label"])

    model = PCTransModel(ModelConfig(**kw))
    load_flax_variables(model, variables)
    initial = copy.deepcopy(model)
    crit = SetCriterion(CriterionConfig(**CRIT))
    solver = build_solver_config(cfg)
    opt = build_optimizer(model, solver)
    train_step = make_train_step(model, crit, opt, build_lr_scheduler(opt, solver), G)
    draws = torch.from_numpy(_reid_draws(rng_key, TINY["num_queries"]))
    t_metrics = train_step(batch, reid_uniform=draws)

    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state[1])
    return types.SimpleNamespace(
        norm=request.param, batch=batch, params=params, initial=initial,
        model=model, crit=crit, solver=solver,
        j_metrics=jax.tree_util.tree_map(np.asarray, metrics),
        j_idx=np.asarray(j_idx), valid=np.asarray(valid),
        j_grad_tree=grads, j_grads=_as_torch(grads, params),
        j_stats=jax.tree_util.tree_map(np.asarray, dict(new_state.batch_stats)),
        t_metrics={k: float(v) for k, v in t_metrics.items()})


def test_matching_indices_match_jax(run):
    """The port's matcher (scipy on the host) picks JAX's JV assignment on
    every valid slot of every layer's prediction."""
    from pctrans_torch.data.targets import targets_from_labels

    model = copy.deepcopy(run.initial).train()
    with torch.no_grad():
        out = model(torch.from_numpy(run.batch["image"]))
    targets = targets_from_labels(torch.from_numpy(run.batch["label"]), G)
    idx, _ = run.crit.match(torch.stack(out["aux_masks"] + [out["pred_masks"]]),
                            targets)
    assert run.valid.sum() >= 4
    np.testing.assert_array_equal(idx.numpy()[:, run.valid], run.j_idx[:, run.valid])


def test_losses_match_jax(run):
    assert set(run.t_metrics) == set(run.j_metrics)
    for k, v in run.j_metrics.items():
        np.testing.assert_allclose(run.t_metrics[k], v, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


# gradients that are zero in exact arithmetic, so both sides hold rounding
# noise only: a key bias adds one constant to a query's attention logits,
# which the softmax removes; an input projection's bias feeds a GroupNorm
# with one channel per group (conv_dim 32, 32 groups), which removes it
EXACT_ZERO = re.compile(r"(_k(content|pos)_proj|input_proj\.\d)\.bias$")


def test_gradients_match_jax(run):
    grads = {n: p.grad for n, p in run.model.named_parameters()}
    assert set(grads) == set(run.j_grads)
    largest = max(float(g.norm()) for g in run.j_grads.values())
    n_zero = 0
    for name, ref in run.j_grads.items():
        ours = grads[name]
        assert ours is not None, name
        if EXACT_ZERO.search(name):
            n_zero += 1
            assert max(float(ours.norm()), float(ref.norm())) <= 1e-5 * largest, name
            continue
        err = float((ours - ref).norm() / ref.norm())
        assert err <= GRAD_REL_FRO, (name, err)
    assert 0 < n_zero < 0.2 * len(grads)


def test_batch_stats_match_jax(run):
    """BN running statistics after the step (the biased-variance update).
    rtol applies to each statistic's largest entry: a batch mean near 0 is
    a difference of O(1) activations that differ by ~1e-5 upstream."""
    state = run.model.state_dict()
    stats = list(_flatten(run.j_stats))
    assert (len(stats) > 0) == (run.norm == "SyncBN")
    for path, ref in stats:
        ours = state[torch_key("batch_stats", path, run.params)]
        np.testing.assert_allclose(ours.numpy(), ref, rtol=STATS_RTOL,
                                   atol=STATS_RTOL * np.abs(ref).max(),
                                   err_msg="/".join(path))


def test_adamw_update_on_jax_gradients_matches_optax(run):
    """The port's AdamW and scheduler fed the JAX gradients give the JAX
    package's optax update.  Both run in f64: the update at step 0 is
    BASE_LR * WARMUP_FACTOR = 1e-7 per unit of Adam's normalised step, so
    an f32 ``new - old`` would be mostly rounding, and optax's f32 bias
    correction ``1 - 0.999**t`` alone is off by 1.3e-5 relative."""
    with jax.enable_x64(True):
        p64, g64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (run.params, run.j_grad_tree))
        tx = jax_build_optimizer(get_cfg_defaults(), p64)
        updates, _ = tx.update(g64, tx.init(p64), p64)
        ref = _as_torch(jax.tree_util.tree_map(np.asarray, updates), run.params)
    model = copy.deepcopy(run.initial).double()
    opt = build_optimizer(model, run.solver)
    sched = build_lr_scheduler(opt, run.solver)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = run.j_grads[n].double()
    opt.step()
    sched.step()
    for n, p in model.named_parameters():
        update = (p.detach() - before[n]).numpy()
        np.testing.assert_allclose(update, ref[n].numpy(), rtol=1e-6,
                                   atol=1e-15, err_msg=n)


def test_decayed_parameters_are_the_jax_kernel_labels():
    model = JaxModel(config=JaxConfig(**TINY, head_norm="SyncBN"), train=True)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, *HW, 3)))["params"]
    labels = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map_with_path(lambda p, _: _is_norm_or_bias_path(p), params))[0]
    kernels = {torch_key("params", tuple(k.key for k in path), params)
               for path, label in labels if label == "kernel"}
    port = PCTransModel(ModelConfig(**TINY, head_norm="SyncBN"))
    assert set(decayed_parameter_names(port)) == kernels
    assert "predictor.query_feat" in kernels                 # embeddings decay
    assert len(kernels) < len(dict(port.named_parameters()))


@pytest.mark.parametrize("step", [0, 1, 500, 999, 1000, 1001, 15000, 29999, 30000])
def test_warmup_poly_matches_optax_schedule(step):
    """rtol 1e-6, widened where the JAX schedule's f32 ``1 - step / total``
    loses digits to cancellation (3e-3 relative at step 29999)."""
    sched = build_lr_schedule(get_cfg_defaults())
    lr = CVPPP_SOLVER.base_lr * warmup_poly_factor(step, CVPPP_SOLVER)
    frac = 1.0 - step / CVPPP_SOLVER.iteration_total
    rtol = max(1e-6, 2.0 ** -23 / frac) if frac > 0 else 1e-6
    np.testing.assert_allclose(lr, float(sched(step)), rtol=rtol, atol=1e-15)


def test_lambda_lr_steps_the_schedule():
    model = torch.nn.Linear(2, 2)
    opt = build_optimizer(model, CVPPP_SOLVER)
    sched = build_lr_scheduler(opt, CVPPP_SOLVER)
    ref = build_lr_schedule(get_cfg_defaults())
    for n in range(3):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(ref(n)), rtol=1e-6)
        opt.step()
        sched.step()


def test_cvppp_solver_and_criterion_equal_yaml_config():
    cfg_dir = Path(__file__).resolve().parents[1] / "configs" / "CVPPP"
    cfg = load_cfg(str(cfg_dir / "CVPPP-PCTrans-Base.yaml"),
                   str(cfg_dir / "CVPPP-PCTrans.yaml"))
    assert build_solver_config(cfg) == CVPPP_SOLVER
    assert build_criterion_config(cfg) == CVPPP_CRITERION
    ref = dataclasses.asdict(build_criterion(cfg).cfg)
    assert dataclasses.asdict(CVPPP_CRITERION) == ref
    assert ref["point_select"] == "dense"
    assert cfg.MODEL.MAX_INSTANCES == 64 and cfg.SOLVER.SAMPLES_PER_BATCH == 2


@pytest.mark.parametrize("key,value", [
    ("SOLVER.NAME", "SGD"), ("SOLVER.LR_SCHEDULER_NAME", "ReduceLROnPlateau"),
    ("SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR"), ("SOLVER.WARMUP_METHOD", "constant"),
    ("SOLVER.CLIP_GRADIENTS.ENABLED", True), ("SOLVER.WEIGHT_DECAY_NORM", 0.01),
    ("SOLVER.SWA.ENABLED", True),
    ("MODEL.MASK_FORMER.TPU_RECIPE.POINT_SELECT", "shared"),
])
def test_formerly_unported_settings_build(key, value):
    """The settings the port refused before the solver and the point modes
    were ported now build their configuration."""
    cfg = get_cfg_defaults()
    node = cfg
    *parents, leaf = key.split(".")
    for name in parents:
        node = node[name]
    node[leaf] = value
    build = build_criterion_config if "POINT_SELECT" in key else build_solver_config
    assert build(cfg) != (CVPPP_CRITERION if "POINT_SELECT" in key else CVPPP_SOLVER)


# ------------------------------------------------------------------ repairs
def test_batchnorm_train_update_matches_flax():
    """One train-mode forward of a ConvNorm: the updated running statistics
    equal flax's mutated ``batch_stats`` (momentum 0.9, biased variance).
    ``nn.BatchNorm2d`` would update the variance with the unbiased one."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 9, 7, 5) * 2.0 + 0.5).astype(np.float32)
    jmod = JaxConvNorm(6, (3, 3), norm="SyncBN", train=True)
    variables = jax.tree_util.tree_map(np.array, dict(jmod.init(jax.random.key(0), x)))
    variables["batch_stats"] = {"BatchNorm_0": {
        "mean": rng.randn(6).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    y, mut = jmod.apply(variables, x, mutable=["batch_stats"])
    ours = ConvNorm(5, 6, 3, norm="SyncBN").train()
    with torch.no_grad():
        ours.conv.weight.copy_(_to_torch(variables["params"]["Conv_0"]["kernel"], "kernel"))
        ours.norm.weight.copy_(torch.from_numpy(variables["params"]["BatchNorm_0"]["scale"]))
        ours.norm.bias.copy_(torch.from_numpy(variables["params"]["BatchNorm_0"]["bias"]))
        ours.norm.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["BatchNorm_0"]["mean"]))
        ours.norm.running_var.copy_(torch.from_numpy(variables["batch_stats"]["BatchNorm_0"]["var"]))
        out = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(ours.norm.running_mean.numpy(), ref["mean"], rtol=1e-6)
    np.testing.assert_allclose(ours.norm.running_var.numpy(), ref["var"], rtol=1e-6)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)


def test_eval_after_a_train_step_runs_in_eval_mode():
    """An Evaluator built before a train step still evaluates in eval mode:
    its masks equal a fresh eval-mode evaluator's, and the eval call leaves
    the BN running statistics as the train step left them."""
    model = PCTransModel(ModelConfig(**TINY, head_norm="SyncBN"),
                         generator=torch.Generator().manual_seed(0))
    ev = Evaluator(model, top_k=4)
    opt = build_optimizer(model, CVPPP_SOLVER)
    step = make_train_step(model, SetCriterion(CriterionConfig(**CRIT)), opt,
                           build_lr_scheduler(opt, CVPPP_SOLVER), G,
                           torch.Generator().manual_seed(0))
    step(_batch())
    assert model.training
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    assert stats
    images = _batch(1)["image"]
    masks = ev.predict_masks(images)
    for k, v in model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(v, stats[k], rtol=0, atol=0)
    ref = Evaluator(copy.deepcopy(model).eval(), top_k=4).predict_masks(images)
    np.testing.assert_array_equal(masks, ref)
