"""The port's solver against the JAX package's (``pctrans_tpu/engine/
solver.py``, ``engine/swa.py``): every LR schedule and warmup, the SWA rate
switch, the three optimizers with the 3-group decay and each gradient
clipping, the ReduceLROnPlateau scale, and the SWA average.

Tolerances: learning rates at rel 1e-6 (the JAX schedules compute in f32,
the port in f64; an absolute 2^-22 of BASE_LR covers f32 cancellation where
the rate nears 0); the optimizers in f64 on both sides (``jax.enable_x64``;
the JAX schedule still rounds the rate to f32), updates at rel 1e-5; the SWA
average elementwise in f32, equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pctrans_tpu.config import get_cfg_defaults
from pctrans_tpu.engine.solver import build_lr_schedule, reduce_on_plateau
from pctrans_tpu.engine.solver import build_optimizer as jax_build_optimizer
from pctrans_tpu.engine.swa import SWAState as JaxSWAState
from pctrans_tpu.engine.swa import maybe_update_swa as jax_maybe_update_swa
from pctrans_torch.engine.solver import (SolverConfig, build_lr_scheduler,
                                         build_optimizer, build_solver_config,
                                         clip_gradients, lr_factor, parameter_groups)
from pctrans_torch.engine.swa import SWAState, maybe_update_swa

torch.set_num_threads(1)

LR_RTOL = 1e-6
UPDATE_RTOL = 1e-5
N_STEPS = 20

SCHEDULES = {
    "poly": {},
    "poly_constant_warmup": {"SOLVER.WARMUP_METHOD": "constant"},
    "cosine": {"SOLVER.LR_SCHEDULER_NAME": "WarmupCosineLR"},
    "warmup_multistep": {"SOLVER.LR_SCHEDULER_NAME": "WarmupMultiStepLR",
                         "SOLVER.STEPS": (6, 12), "SOLVER.GAMMA": 0.5},
    "multistep": {"SOLVER.LR_SCHEDULER_NAME": "MultiStepLR",
                  "SOLVER.STEPS": (3, 12), "SOLVER.GAMMA": 0.5},
    "one_cycle": {"SOLVER.LR_SCHEDULER_NAME": "OneCycle"},
    "plateau": {"SOLVER.LR_SCHEDULER_NAME": "ReduceLROnPlateau"},
    "cosine_swa": {"SOLVER.LR_SCHEDULER_NAME": "WarmupCosineLR",
                   "SOLVER.SWA.ENABLED": True, "SOLVER.SWA.START_ITER": 11},
}


def _cfg(**overrides):
    cfg = get_cfg_defaults()
    base = {"SOLVER.BASE_LR": 1e-3, "SOLVER.ITERATION_TOTAL": N_STEPS,
            "SOLVER.WARMUP_ITERS": 5, "SOLVER.WARMUP_FACTOR": 0.01}
    for key, value in {**base, **overrides}.items():
        node = cfg
        *parents, leaf = key.split(".")
        for name in parents:
            node = node[name]
        node[leaf] = value
    return cfg


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax_at_every_step(name):
    """The rate of update n (0..N), from the port's scheduler as the
    optimizer sees it and from ``lr_factor``, against ``build_lr_schedule``."""
    cfg = _cfg(**SCHEDULES[name])
    ref = build_lr_schedule(cfg)
    s = build_solver_config(cfg)
    opt = build_optimizer(nn.Linear(2, 2), s)
    sched = build_lr_scheduler(opt, s)
    atol = 2.0 ** -22 * s.base_lr
    for n in range(N_STEPS + 1):
        want = float(ref(n))
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want, rtol=LR_RTOL,
                                   atol=atol, err_msg=f"step {n}")
        np.testing.assert_allclose(s.base_lr * lr_factor(n, s), want, rtol=LR_RTOL,
                                   atol=atol, err_msg=f"step {n}")
        opt.step()
        sched.step()


def test_one_cycle_does_not_cycle_momentum():
    """OneCycle sets the rate only: AdamW's beta1 stays SOLVER.BETAS[0]
    (``torch.optim.lr_scheduler.OneCycleLR`` would cycle it)."""
    s = build_solver_config(_cfg(**SCHEDULES["one_cycle"]))
    opt = build_optimizer(nn.Linear(2, 2), s)
    sched = build_lr_scheduler(opt, s)
    for _ in range(N_STEPS):
        opt.step()
        sched.step()
        assert all(g["betas"] == (0.9, 0.999) for g in opt.param_groups)


@pytest.mark.parametrize("key,value", [
    ("SOLVER.NAME", "Adagrad"), ("SOLVER.LR_SCHEDULER_NAME", "StepLR"),
    ("SOLVER.WARMUP_METHOD", "exp")])
def test_unknown_names_raise_value_error(key, value):
    cfg = _cfg(**{key: value})
    with pytest.raises(ValueError):
        build_lr_schedule(cfg)(1) if key != "SOLVER.NAME" else \
            jax_build_optimizer(cfg, {"w": jnp.zeros(2)})
    with pytest.raises(ValueError, match=key.split(".", 1)[1]):
        build_solver_config(cfg)


class Tiny(nn.Module):
    """A weight, a bias, a norm layer and an embedding: every decay group."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 4, 3)
        self.norm = nn.GroupNorm(2, 4)
        self.query_feat = nn.Embedding(5, 4)


# torch name -> the flax path of the same array, as the JAX labels see it
TINY_PATHS = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
              "norm.weight": ("norm", "scale"), "norm.bias": ("norm", "bias"),
              "query_feat.weight": ("query_feat", "embedding")}


def test_parameter_groups_are_the_jax_labels():
    from pctrans_tpu.engine.solver import _is_norm_or_bias_path

    tree = {a: {b: np.zeros(1) for (a2, b) in TINY_PATHS.values() if a2 == a}
            for a, _ in TINY_PATHS.values()}
    labels = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map_with_path(lambda p, _: _is_norm_or_bias_path(p), tree))[0])
    by_path = {tuple(k.key for k in path): label for path, label in labels.items()}
    ours = {n: label for label, names in parameter_groups(Tiny()).items() for n in names}
    assert ours == {n: by_path[p] for n, p in TINY_PATHS.items()}
    assert set(ours.values()) == {"kernel", "bias", "norm"}


def _tiny_arrays(seed):
    rng = np.random.RandomState(seed)
    model = Tiny()
    return {n: rng.randn(*p.shape) * 0.5 for n, p in model.named_parameters()}


def _to_tree(arrays):
    tree = {}
    for n, (a, b) in TINY_PATHS.items():
        tree.setdefault(a, {})[b] = jnp.asarray(arrays[n], jnp.float64)
    return tree


def _from_tree(tree):
    return {n: np.asarray(tree[a][b]) for n, (a, b) in TINY_PATHS.items()}


def _run_both(cfg, grads, losses):
    """len(grads) updates in each package (f64) from the same parameters;
    returns (ours, ref) parameter deltas by torch name."""
    params = _tiny_arrays(0)
    with jax.enable_x64(True):
        tree = _to_tree(params)
        tx = jax_build_optimizer(cfg, tree)
        state = tx.init(tree)
        for g, loss in zip(grads, losses):
            updates, state = tx.update(_to_tree(g), state, tree, value=loss)
            tree = optax.apply_updates(tree, updates)
        ref = {n: a - params[n] for n, a in _from_tree(tree).items()}
    model = Tiny().double()
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    s = build_solver_config(cfg)
    opt = build_optimizer(model, s)
    sched = build_lr_scheduler(opt, s)
    for g, loss in zip(grads, losses):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        clip_gradients(model.parameters(), s)
        opt.step()
        sched.observe(loss)
        sched.step()
    ours = {n: p.detach().numpy() - params[n] for n, p in model.named_parameters()}
    return ours, ref


def _grads(scale, clip_value, n=3, seed=1):
    """n gradient sets; each set's global L2 norm is ``scale * clip_value``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        g = {k: rng.randn(*v.shape) for k, v in _tiny_arrays(0).items()}
        norm = np.sqrt(sum((v ** 2).sum() for v in g.values()))
        out.append({k: v / norm * scale * clip_value for k, v in g.items()})
    return out


CLIPS = [None, ("full_model", 0.5), ("norm", 1.0), ("full_model", 3.0), ("value", 3.0)]


@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD"])
@pytest.mark.parametrize("clip", CLIPS, ids=lambda c: "none" if c is None else f"{c[0]}-{c[1]}")
def test_optimizer_matches_optax_after_three_updates(name, clip):
    """Three updates; AdamW decays weights, biases and norm parameters at
    three different rates.  Clipping below (0.5), at (1.0) and across (3.0)
    its bound: the gradients' global norm is that multiple of CLIP_VALUE
    (with ``value`` at 3x most elements lie beyond the bound)."""
    overrides = {"SOLVER.NAME": name, "SOLVER.WARMUP_ITERS": 2,
                 "SOLVER.WEIGHT_DECAY_NORM": 0.01, "SOLVER.WEIGHT_DECAY_BIAS": 0.02,
                 "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 0.05}
    scale = 1.0
    if clip is not None:
        overrides.update({"SOLVER.CLIP_GRADIENTS.ENABLED": True,
                          "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": clip[0]})
        scale = clip[1]
    cfg = _cfg(**overrides)
    grads = _grads(scale, 0.05 if clip and clip[0] != "value" else 0.05 * 30)
    ours, ref = _run_both(cfg, grads, [1.0, 0.9, 0.8])
    for n in ref:
        np.testing.assert_allclose(ours[n], ref[n], rtol=UPDATE_RTOL,
                                   atol=1e-12 * np.abs(ref[n]).max(), err_msg=n)
        assert np.abs(ref[n]).max() > 0


def test_plateau_scale_matches_jax_over_a_tripping_sequence():
    """Losses that improve for 10 steps, then stay flat: the scale falls by
    GAMMA after every 1001 steps without a 0.1% improvement and stops at
    1e-6 / BASE_LR."""
    losses = np.concatenate([np.linspace(2.0, 1.0, 10), np.full(3200, 1.0)])
    cfg = _cfg(**{"SOLVER.LR_SCHEDULER_NAME": "ReduceLROnPlateau",
                  "SOLVER.BASE_LR": 1e-4})
    s = build_solver_config(cfg)
    tx = reduce_on_plateau(factor=s.gamma, patience=1000, threshold=0.001,
                           min_scale=1e-6 / s.base_lr)

    def body(state, loss):
        _, state = tx.update({"w": jnp.ones(())}, state, value=loss)
        return state, state.scale

    _, ref = jax.lax.scan(body, tx.init(None), jnp.asarray(losses, jnp.float32))
    sched = build_lr_scheduler(build_optimizer(nn.Linear(2, 2), s), s)
    ours = []
    for loss in losses:
        sched.observe(float(np.float32(loss)))
        ours.append(sched.scale)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-6)
    assert sorted(set(np.round(ours, 8))) == [0.01, 0.1, 1.0]


def test_plateau_scales_the_update_after_the_loss_that_trips_it():
    """SGD under ReduceLROnPlateau for 1012 updates on flat losses: the
    update after the trip takes the lower rate, in both packages."""
    n = 1012
    cfg = _cfg(**{"SOLVER.NAME": "SGD", "SOLVER.LR_SCHEDULER_NAME": "ReduceLROnPlateau",
                  "SOLVER.MOMENTUM": 0.0})
    grads = _grads(1.0, 1.0, n=1, seed=2) * n
    ours, ref = _run_both(cfg, grads, [1.0] * n)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=UPDATE_RTOL, err_msg=k)
    g = grads[0]["conv.bias"]
    # 1002 updates at BASE_LR, then 10 at a tenth of it
    np.testing.assert_allclose(ours["conv.bias"], -1e-3 * g * (1002 + 10 * 0.1), rtol=1e-9)


def test_swa_average_matches_jax():
    rng = np.random.RandomState(3)
    snaps = [{"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
             for _ in range(8)]
    ref, ours = JaxSWAState(), SWAState()
    for it, snap in enumerate(snaps, start=1):
        ref = jax_maybe_update_swa(ref, {k: jnp.asarray(v) for k, v in snap.items()},
                                   it, start_iter=2, merge_iter=2)
        ours = maybe_update_swa(ours, {k: torch.from_numpy(v) for k, v in snap.items()},
                                it, start_iter=2, merge_iter=2)
    assert ours.count == ref.count == 4
    for k in snaps[0]:
        np.testing.assert_array_equal(ours.params[k].numpy(), np.asarray(ref.params[k]))


def test_solver_config_defaults_are_the_config_defaults():
    assert build_solver_config(get_cfg_defaults()) == SolverConfig()
