"""The port's train step with the Swin backbone against the JAX package's
``make_train_step``: ``tests/test_torch_train_step.py``'s tiny config,
batch and criterion with a Swin-T of embed 16, depths (2, 2, 2, 2), heads
(2, 2, 4, 4), window 7 for the ResNet, GN heads, drop path 0, at 64x64:
the losses, every gradient and one AdamW update on JAX's gradients.  At
64x64 the last two stages clamp the window (4x4 and 2x2 maps), so JAX's
tables there have the clamped windows' sizes and their gradients are
compared at the centre of the port's full-window tables.

JAX's step passes no dropout key to the model, so it cannot run Swin's
drop path at all (flax raises for the missing ``dropout`` key); the port
draws drop path from the step's generator, checked here on the port alone.
Also here: the step refuses the DETR predictor, and the trainer refuses
``MODEL.WEIGHTS`` (an R-50 pickle) with a Swin backbone.
"""

import copy
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.config import get_cfg_defaults
from pctrans_tpu.engine.solver import build_optimizer as jax_build_optimizer
from pctrans_tpu.engine.state import TrainState
from pctrans_tpu.engine.state import make_train_step as jax_make_train_step
from pctrans_tpu.losses import CriterionConfig as JaxCriterionConfig
from pctrans_tpu.losses import SetCriterion as JaxCriterion
from pctrans_tpu.models import ModelConfig as JaxConfig
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_torch import config as torch_config
from pctrans_torch.config import ModelConfig
from pctrans_torch.engine.solver import (CVPPP_SOLVER, build_lr_scheduler, build_optimizer,
                                         build_solver_config)
from pctrans_torch.engine.train_step import make_train_step
from pctrans_torch.engine.trainer import Trainer
from pctrans_torch.losses.criterion import CriterionConfig, SetCriterion
from pctrans_torch.models import PCTransModel
from pctrans_torch.weights import (_flatten, _full_window_table, _to_torch,
                                   load_flax_variables, torch_key)
from test_torch_alt_components import _init
from test_torch_train_step import (CRIT, EXACT_ZERO, G, GRAD_REL_FRO, HW, LOSS_ATOL,
                                   LOSS_RTOL, TINY, _batch, _recording, _reid_draws)
from test_torch_trainer import tiny_opts

torch.set_num_threads(1)

# EXACT_ZERO and the biases of the backbone's output norms: each is added at
# every pixel of its map, the 1x1 conv that reads the map (an input
# projection, or the res2 FPN lateral) turns it into a per-channel constant,
# and the GroupNorm after that conv (one channel per group) removes it
SWIN_EXACT_ZERO = re.compile(EXACT_ZERO.pattern + r"|backbone\.out_norm\.\d\.bias$")
SWIN = dict(TINY, head_norm="GN", backbone_name="D2SwinTransformer", swin_embed_dim=16,
            swin_depths=(2, 2, 2, 2), swin_num_heads=(2, 2, 4, 4), swin_drop_path=0.0)


def _as_torch(tree, params, state):
    """flax param-shaped numpy tree -> {torch name: tensor}, clamped
    windows' tables placed in the full-window tables."""
    out = {}
    for path, a in _flatten(tree):
        key = torch_key("params", path, params)
        t = _to_torch(a, path[-1], path[-2])
        if path[-1] == "relative_position_bias_table":
            t = _full_window_table(t, state[key].shape)
        out[key] = t
    return out


@pytest.fixture(scope="module")
def run():
    jcfg = JaxConfig(**SWIN)
    jmodel = JaxModel(config=jcfg, train=True)
    variables = _init(jmodel, jnp.zeros((1, *HW, 3)))
    params = variables["params"]
    cfg = get_cfg_defaults()
    tx = _recording(jax_build_optimizer(cfg, params))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, frozen={},
                       batch_stats={}, opt_state=tx.init(params))
    step = jax.jit(jax_make_train_step(jcfg, JaxCriterion(JaxCriterionConfig(**CRIT)), tx,
                                       max_instances=G))
    batch = _batch()
    rng_key = jax.random.key(0)
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng_key)

    model = PCTransModel(ModelConfig(**SWIN))
    load_flax_variables(model, variables)
    initial = copy.deepcopy(model)
    solver = build_solver_config(cfg)
    opt = build_optimizer(model, solver)
    train_step = make_train_step(model, SetCriterion(CriterionConfig(**CRIT)), opt,
                                 build_lr_scheduler(opt, solver), G)
    t_metrics = train_step(batch, reid_uniform=torch.from_numpy(
        _reid_draws(rng_key, TINY["num_queries"])))
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state[1])
    return types.SimpleNamespace(
        params=params, model=model, initial=initial, solver=solver, j_grad_tree=grads,
        j_grads=_as_torch(grads, params, model.state_dict()),
        j_metrics=jax.tree_util.tree_map(np.asarray, metrics),
        t_metrics={k: float(v) for k, v in t_metrics.items()})


def test_swin_step_losses_match_jax(run):
    assert set(run.t_metrics) == set(run.j_metrics)
    for k, v in run.j_metrics.items():
        np.testing.assert_allclose(run.t_metrics[k], v, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)


def test_swin_step_gradients_match_jax(run):
    """Every gradient within ``tests/test_torch_train_step.py``'s rel-Fro,
    the backbone's included; where the gradient is zero in exact arithmetic
    (``SWIN_EXACT_ZERO``), both sides hold rounding noise only."""
    grads = {n: p.grad for n, p in run.model.named_parameters()}
    assert set(grads) == set(run.j_grads)
    largest = max(float(g.norm()) for g in run.j_grads.values())
    n_backbone = 0
    for name, ref in run.j_grads.items():
        ours = grads[name]
        if SWIN_EXACT_ZERO.search(name):
            assert max(float(ours.norm()), float(ref.norm())) <= 1e-5 * largest, name
            continue
        err = float((ours - ref).norm() / ref.norm())
        assert err <= GRAD_REL_FRO, (name, err)
        n_backbone += name.startswith("backbone.")
    assert n_backbone == sum(n.startswith("backbone.") and not SWIN_EXACT_ZERO.search(n)
                             for n in grads) > 100


def test_swin_update_on_jax_gradients_matches_optax(run):
    """The port's AdamW and scheduler fed JAX's gradients give optax's
    update, in f64 as ``tests/test_torch_train_step.py`` does."""
    with jax.enable_x64(True):
        p64, g64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (run.params, run.j_grad_tree))
        tx = jax_build_optimizer(get_cfg_defaults(), p64)
        updates, _ = jax.jit(tx.update)(g64, tx.init(p64), p64)
        ref = _as_torch(jax.tree_util.tree_map(np.asarray, updates), run.params,
                        run.initial.state_dict())
    model = copy.deepcopy(run.initial).double()
    opt = build_optimizer(model, run.solver)
    sched = build_lr_scheduler(opt, run.solver)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = run.j_grads[n].double()
    opt.step()
    sched.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[n]).numpy(), ref[n].numpy(),
                                   rtol=1e-6, atol=1e-15, err_msg=n)


# ------------------------------------------------------------- port alone
def _port_step(drop_path, seed, transformer_decoder="MultiScaleMaskedTransformerDecoder"):
    model = PCTransModel(ModelConfig(**dict(SWIN, swin_drop_path=drop_path,
                                            transformer_decoder_name=transformer_decoder,
                                            pixel_decoder_name="TransformerEncoderPixelDecoder")),
                         generator=torch.Generator().manual_seed(0))
    opt = build_optimizer(model, CVPPP_SOLVER)
    return make_train_step(model, SetCriterion(CriterionConfig(**CRIT)), opt,
                           build_lr_scheduler(opt, CVPPP_SOLVER), G,
                           torch.Generator().manual_seed(seed))


def test_drop_path_draws_from_the_step_generator():
    batch = _batch()
    a, b, c = (float(_port_step(0.3, s)(batch)["loss"]) for s in (7, 7, 8))
    assert a == b and a != c
    off = [float(_port_step(0.0, s)(batch)["loss_mask"]) for s in (7, 8)]
    assert off[0] == off[1]           # without drop path the seed reaches the criterion only


def test_step_refuses_the_detr_predictor():
    with pytest.raises(ValueError, match="StandardTransformerDecoder"):
        _port_step(0.0, 0, "StandardTransformerDecoder")


def test_trainer_refuses_r50_weights_for_swin(tmp_path):
    weights = tmp_path / "R-50.pkl"
    weights.write_bytes(b"")
    cfg = torch_config.load_cfg(opts=tiny_opts(tmp_path) + [
        "MODEL.BACKBONE.NAME", "D2SwinTransformer", "MODEL.WEIGHTS", str(weights)])
    with pytest.raises(ValueError, match="D2SwinTransformer"):
        Trainer(cfg, mode="train", device="cpu")
