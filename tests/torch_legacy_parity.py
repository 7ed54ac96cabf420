"""Shared parity helpers of the legacy-zoo tests (``test_torch_legacy_zoo.py``,
``test_torch_legacy_deeplab.py``, ``test_torch_legacy_models.py``): flax variables drawn from a numpy seed
through ``jax.eval_shape``, and one check of a port model against its JAX
twin (forward, running statistics, parameter gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pctrans_torch.weights import _flatten, _to_torch, legacy_torch_key, \
    load_flax_legacy_variables

FWD_REL_FRO = 1e-5
GRAD_REL_FRO = 1e-4
ZERO_GRAD_SHARE = 1e-3


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def nhwc(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def nchw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


def flax_variables(module, x, seed=0):
    """The module's variables at ``x``'s shape: kernels at LeCun's variance,
    norm scales in [0.5, 1.5], biases and running means at 0.1, running
    variances in [0.5, 1.5], BotNet's embeddings at dim_head ** -0.5."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            a = 0.1 * rng.randn(*shape)
        elif name.startswith("pos_emb_"):
            a = rng.randn(*shape) / np.sqrt(shape[-1])
        else:
            raise KeyError(name)
        return a.astype(np.float32)

    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.asarray(nhwc(x)))
    return {c: jax.tree_util.tree_map_with_path(draw, dict(t)) for c, t in shapes.items()}


def outputs(out, nhwc):
    """A model's outputs as a dict of channel-first numpy-able arrays."""
    out = out if isinstance(out, dict) else {"out": out}
    return {k: (jnp.moveaxis(v, -1, 1) if nhwc else v) for k, v in out.items()}


def check_pair(jmodel, variables, model, x, train, grads=False, seed=1):
    """Load ``variables`` into ``model`` and hold its forward (train mode: also
    the running statistics after flax's update; ``grads``: the parameter
    gradients of a weighted sum of the outputs) to ``jmodel``'s."""
    load_flax_legacy_variables(model, variables)
    model.train(train)
    xj = jnp.asarray(nhwc(x))
    ours = outputs(model(torch.from_numpy(x)), False)
    weights = {k: np.random.RandomState(seed).randn(*v.shape).astype(np.float32)
               for k, v in ours.items()}

    def jloss(params):
        rest = {c: t for c, t in variables.items() if c != "params"}
        if train:
            out, stats = jmodel.apply(dict(rest, params=params), xj, mutable=["batch_stats"])
        else:
            out, stats = jmodel.apply(dict(rest, params=params), xj), {}
        out = outputs(out, True)
        loss = sum(jnp.sum(out[k] * weights[k]) for k in out)
        return loss, (out, stats)

    if grads:
        (_, (ref, stats)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            variables["params"])
    else:
        _, (ref, stats) = jloss(variables["params"])
    assert set(ours) == set(ref)
    for k in ours:
        assert ours[k].dtype == torch.float32
        assert tuple(ours[k].shape) == ref[k].shape, k
        assert rel_fro(ours[k].detach().numpy(), ref[k]) <= FWD_REL_FRO, k
    state = model.state_dict()
    for path, v in _flatten(jax.tree_util.tree_map(np.asarray,
                                                   dict(stats.get("batch_stats", {})))):
        key = legacy_torch_key("batch_stats", path)
        np.testing.assert_allclose(state[key].numpy(), v, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    if grads:
        sum((ours[k] * torch.from_numpy(weights[k])).sum() for k in ours).backward()
        check_grads(model, jgrads)


def check_grads(model, jgrads):
    """The parameter gradients against JAX's: all of them within
    GRAD_REL_FRO rel-Fro, and each tensor within GRAD_REL_FRO of the larger
    of its norm and ZERO_GRAD_SHARE of the whole gradient's.  Below that
    share a gradient is 0 in exact arithmetic (the bias of a BatchNorm whose
    every consumer is a linear map into another train-mode BatchNorm, read
    at 1e-9 to 4e-8 of the whole), and both sides hold rounding noise."""
    params = dict(model.named_parameters())
    flat = list(_flatten(jax.tree_util.tree_map(np.asarray, dict(jgrads))))
    assert len(flat) == len(params)
    pairs = {}
    for path, g in flat:
        key = legacy_torch_key("params", path)
        pairs[key] = (params[key].grad.numpy().astype(np.float64),
                      _to_torch(g, path[-1], path[-2] if len(path) > 1 else "")
                      .numpy().astype(np.float64))
    whole = np.sqrt(sum(np.sum(b * b) for _, b in pairs.values()))
    diff = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs.values()))
    assert diff <= GRAD_REL_FRO * whole
    for key, (a, b) in pairs.items():
        scale = max(np.linalg.norm(b), ZERO_GRAD_SHARE * whole)
        assert np.linalg.norm(a - b) <= GRAD_REL_FRO * scale, key


def input_array(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)
