"""The port's legacy losses, regularisers, ``SplitActivation`` and
``LegacyCriterion`` against the JAX package's (``pctrans_tpu/losses/
legacy.py``), channel-first on both sides, with and without weight masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.config import get_cfg_defaults as jax_cfg_defaults
from pctrans_tpu.losses import legacy as J
from pctrans_torch.config import get_cfg_defaults
from pctrans_torch.losses import legacy as T

torch.set_num_threads(1)

RTOL = 1e-5
SHAPE = (2, 3, 4, 8, 8)          # [B, C, Z, Y, X]


def _data(seed=0, shape=SHAPE):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(*shape)).astype(np.float32)
    prob = (1 / (1 + np.exp(-logits))).astype(np.float32)
    target = (rng.rand(*shape) > 0.6).astype(np.float32)
    weight = rng.uniform(0.2, 2.0, shape).astype(np.float32)
    return logits, prob, target, weight


def _close(port, ref, rtol=RTOL):
    np.testing.assert_allclose(float(port), float(ref), rtol=rtol, atol=1e-7)


# (name, kwargs, input kind): "prob" feeds probabilities, "logits" logits
LOSSES = [
    ("DiceLoss", {}, "prob"), ("DiceLoss", {"reduce": False, "power": 2}, "prob"),
    ("WeightedMSE", {}, "logits"), ("WeightedMAE", {}, "logits"),
    ("WeightedBCE", {}, "prob"), ("WeightedBCEWithLogitsLoss", {}, "logits"),
    ("WeightedBCEWithLogitsLoss", {"eps": 0.1}, "logits"),
    ("WeightedBCEFocalLoss", {}, "logits"),
    ("WeightedBCEFocalLoss", {"gamma": 1.5, "alpha": 0.4, "eps": 0.05}, "logits"),
    ("WSDiceLoss", {}, "prob"),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,kwargs,kind", LOSSES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(LOSSES)])
def test_binary_losses_match_jax(name, kwargs, kind, weighted):
    logits, prob, target, weight = _data()
    pred = prob if kind == "prob" else logits
    w = weight if weighted else None
    ref = getattr(J, name)(**kwargs)(jnp.asarray(pred), jnp.asarray(target),
                                     None if w is None else jnp.asarray(w))
    out = getattr(T, name)(**kwargs)(torch.from_numpy(pred), torch.from_numpy(target),
                                     None if w is None else torch.from_numpy(w))
    _close(out, ref)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,kwargs", [
    ("WeightedCE", {}), ("WeightedCE", {"class_weight": [0.5, 1.0, 2.0]}),
    ("WeightedLS", {"classes": 3}),
    ("WeightedLS", {"classes": 3, "cls_weights": [1.0, 0.3, 2.0], "smoothing": 0.1})])
def test_class_losses_match_jax(name, kwargs, weighted):
    logits, _, _, weight = _data(1)
    labels = np.random.RandomState(2).randint(0, 3, (2, 4, 8, 8))
    w = weight[:, 0] if weighted else None
    ref = getattr(J, name)(**kwargs)(jnp.asarray(logits), jnp.asarray(labels),
                                     None if w is None else jnp.asarray(w))
    out = getattr(T, name)(**kwargs)(torch.from_numpy(logits), torch.from_numpy(labels),
                                     None if w is None else torch.from_numpy(w))
    _close(out, ref)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
@pytest.mark.parametrize("real", [False, True])
def test_gan_loss_matches_jax(mode, real):
    """On a discriminator's logits; no discriminator model is needed."""
    logits = _data(3, (4, 1, 3, 6, 6))[0]
    ref = J.GANLoss(mode, 0.9, 0.1)(jnp.asarray(logits), real)
    out = T.GANLoss(mode, 0.9, 0.1)(torch.from_numpy(logits), real)
    _close(out, ref)


def test_gan_loss_refuses_unknown_mode():
    with pytest.raises(NotImplementedError):
        T.GANLoss("hinge")(torch.zeros(2), True)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,n_inputs", [
    ("BinaryReg", 1), ("ForegroundDTConsistency", 2), ("ContourDTConsistency", 2),
    ("FgContourConsistency", 2)])
def test_regularisers_match_jax(name, n_inputs, masked):
    a, _, _, weight = _data(4, (2, 1, 3, 9, 7))
    b = _data(5, (2, 1, 3, 9, 7))[0]
    inputs = [a, b][:n_inputs]
    mask = [weight] if masked else []
    ref = getattr(J, name)()(*[jnp.asarray(x) for x in inputs + mask])
    out = getattr(T, name)()(*[torch.from_numpy(x) for x in inputs + mask])
    _close(out, ref)


@pytest.mark.parametrize("fg_masked", [False, True])
def test_nonoverlap_matches_jax(fg_masked):
    logits = _data(6)[0]
    ref = J.NonoverlapReg(fg_masked)(jnp.asarray(logits))
    out = T.NonoverlapReg(fg_masked)(torch.from_numpy(logits))
    _close(out, ref)


@pytest.mark.parametrize("target_opt,acts,do_2d", [
    (["0", "1", "2"], ["sigmoid", "none", "tanh"], False),
    (["0", "2", "all"], ["none", "sigmoid", "softmax"], True),
    (["I-2", "5-d-0-1-1", "9-3"], ["tanh", "none", "softmax"], False),
    (["7", "3", "4", "5", "6", "8"], None, False)])
def test_split_activation_matches_jax(target_opt, acts, do_2d):
    x = _data(7, (2, 20, 2, 4, 4))[0]
    ref = J.SplitActivation(target_opt, acts, do_2d=do_2d)(jnp.asarray(x))
    out = T.SplitActivation(target_opt, acts, do_2d=do_2d)(torch.from_numpy(x))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=1e-7)


def test_split_activation_refuses_all_before_the_last():
    with pytest.raises(ValueError):
        T.SplitActivation(["all", "0"])


CRITERION = dict(
    target_opt=["0", "1", "2"],
    loss_opt=[["WeightedBCEWithLogitsLoss", "DiceLoss"], ["WeightedMSE"],
              ["WeightedBCEFocalLoss", "WSDiceLoss"]],
    output_act=[["none", "sigmoid"], ["tanh"], ["none", "sigmoid"]],
    loss_weight=[[1.0, 0.5], [2.0], [1.0, 0.3]],
    loss_kwargs=[[{"eps": 0.05}, None], None, [{"gamma": 1.0}, {"power": 1.0}]],
    regu_opt=["Binary", "ContourDT"], regu_target=[[0], [0, 1]], regu_weight=[0.1, 0.2])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("as_dict", [False, True])
def test_legacy_criterion_matches_jax(weighted, as_dict):
    """Totals and per-term dicts; weight maps per (target, loss), the size-1
    placeholder meaning none; a DeepLab-style {"out", "aux"} prediction."""
    x = _data(8, (2, 7, 2, 6, 6))[0]
    rng = np.random.RandomState(9)
    targets = [(rng.rand(2, c, 2, 6, 6) > 0.5).astype(np.float32) for c in (1, 3, 3)]
    weights = None
    if weighted:
        weights = [[rng.uniform(0.5, 1.5, t.shape).astype(np.float32), np.zeros(1)]
                   for t in targets]
    pred = {"out": x, "aux": 0.5 * x} if as_dict else x
    jpred = ({k: jnp.asarray(v) for k, v in pred.items()} if as_dict else jnp.asarray(x))
    tpred = ({k: torch.from_numpy(v) for k, v in pred.items()} if as_dict
             else torch.from_numpy(x))
    ref_total, ref_terms = J.LegacyCriterion(**CRITERION)(
        jpred, [jnp.asarray(t) for t in targets], weights)
    total, terms = T.LegacyCriterion(**CRITERION)(
        tpred, [torch.from_numpy(t) for t in targets], weights)
    assert list(terms) == list(ref_terms)
    _close(total, ref_total)
    for k in ref_terms:
        _close(terms[k], ref_terms[k])


def test_build_from_cfg_matches_jax():
    cfgs = []
    for defaults in (jax_cfg_defaults, get_cfg_defaults):
        cfg = defaults()
        cfg.MODEL.TARGET_OPT = ["0", "2"]
        cfg.MODEL.LOSS_OPTION = [["WeightedBCEWithLogitsLoss", "DiceLoss"], ["WeightedMSE"]]
        cfg.MODEL.OUTPUT_ACT = [["none", "sigmoid"], ["tanh"]]
        cfg.MODEL.LOSS_WEIGHT = [[1.0, 0.5], [3.0]]
        cfg.MODEL.LOSS_KWARGS_KEY = [[["eps"], []], []]
        cfg.MODEL.LOSS_KWARGS_VAL = [[[0.1], []], []]
        cfg.MODEL.REGU_OPT = ["FgDT"]
        cfg.MODEL.REGU_TARGET = [[0, 1]]
        cfg.MODEL.REGU_WEIGHT = [0.5]
        cfgs.append(cfg)
    x = _data(10, (2, 3, 2, 6, 6))[0]
    rng = np.random.RandomState(11)
    targets = [(rng.rand(2, c, 2, 6, 6) > 0.5).astype(np.float32) for c in (1, 2)]
    jcrit = J.LegacyCriterion.build_from_cfg(cfgs[0])
    tcrit = T.LegacyCriterion.build_from_cfg(cfgs[1])
    assert tcrit.loss_fn[0][0] == T.WeightedBCEWithLogitsLoss(eps=0.1)
    ref_total, ref_terms = jcrit(jnp.asarray(x), [jnp.asarray(t) for t in targets])
    total, terms = tcrit(torch.from_numpy(x), [torch.from_numpy(t) for t in targets])
    assert list(terms) == list(ref_terms)
    _close(total, ref_total)
