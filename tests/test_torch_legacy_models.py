"""The port's legacy block zoo and U-Nets against the JAX package's
(``pctrans_tpu/models/legacy/{blocks,unet}.py``) at tiny widths.

The flax variables (randomised BatchNorm affine and statistics, so every
path of the bridge carries data) go through ``load_flax_legacy_variables``;
inputs are NCDHW / NCHW in the port and channels-last in JAX.  The JAX
forwards run eagerly: at these sizes that is quicker than a compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.config import get_cfg_defaults as jax_cfg_defaults
from pctrans_tpu.losses.legacy import LegacyCriterion as JaxCriterion
from pctrans_tpu.models import build_architecture as jax_build_architecture
from pctrans_tpu.models.legacy import MODEL_MAP as JAX_MODEL_MAP
from pctrans_tpu.models.legacy import blocks as jax_blocks
from pctrans_torch.config import get_cfg_defaults
from pctrans_torch.losses.legacy import LegacyCriterion
from pctrans_torch.models import build_architecture
from pctrans_torch.models.legacy import (MODEL_MAP, FPN3D, DeepLabV3, UNet, UNetResidual3D,
                                         linear_resize)
from pctrans_torch.weights import _flatten, legacy_torch_key, load_flax_legacy_variables
from torch_legacy_parity import check_pair, flax_variables

torch.set_num_threads(1)

FILTERS = (4, 6, 8)
ISOTROPY = (False, True, True)
SHAPES = {2: (2, 2, 16, 16), 3: (2, 1, 4, 16, 16)}      # port layout [B, C, *spatial]
FWD_REL_FRO = 1e-5
GRAD_REL_FRO = 1e-4


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _randomize(tree, rng, col):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, col)
            continue
        a = np.array(v, np.float32)
        if col == "batch_stats":
            a = (rng.uniform(0.5, 1.5, a.shape) if k == "var"
                 else 0.1 * rng.randn(*a.shape)).astype(np.float32)
        elif k == "scale":
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k == "bias":
            a = (0.1 * rng.randn(*a.shape)).astype(np.float32)
        out[k] = a
    return out


def _rank(arch):
    return 3 if arch.endswith("3d") else 2


def _nhwc(x):
    return np.moveaxis(x, 1, -1)


def _pair(arch, block_type, train, seed=0, **kw):
    """(JAX module, its randomised variables, port model loaded with them,
    input in the port's layout)."""
    rank = _rank(arch)
    kwargs = dict(dict(in_channel=SHAPES[rank][1], out_channel=2, filters=FILTERS,
                       block_type=block_type, isotropy=ISOTROPY), **kw)
    jmodel = JAX_MODEL_MAP[arch](train=train, **kwargs)
    rng = np.random.RandomState(seed)
    x = rng.randn(*SHAPES[rank]).astype(np.float32)
    variables = jmodel.init(jax.random.key(seed), jnp.asarray(_nhwc(x)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), rng, c)
                 for c, t in variables.items()}
    model = MODEL_MAP[arch](**kwargs)
    load_flax_legacy_variables(model, variables)
    return jmodel, variables, model.train(train), x


UNETS = ("unet_3d", "unet_2d", "unet_plus_3d", "unet_plus_2d")
CASES = [(arch, block, train) for arch in UNETS
         for block in ("residual", "residual_pa", "residual_se")
         for train in (False, True)]


@pytest.mark.parametrize("arch,block_type,train", CASES)
def test_unet_forward_matches_flax(arch, block_type, train):
    jmodel, variables, model, x = _pair(arch, block_type, train)
    if train:
        jout, jstats = jmodel.apply(variables, jnp.asarray(_nhwc(x)),
                                    mutable=["batch_stats"])
    else:
        jout = jmodel.apply(variables, jnp.asarray(_nhwc(x)))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    assert tuple(out.shape) == (x.shape[0], 2) + x.shape[2:]
    assert rel_fro(_nhwc(out.numpy()), jout) <= FWD_REL_FRO
    if train:        # the running statistics after one flax momentum-0.9 update
        state = model.state_dict()
        for path, ref in _flatten(jax.tree_util.tree_map(np.asarray,
                                                         dict(jstats["batch_stats"]))):
            key = legacy_torch_key("batch_stats", path)
            np.testing.assert_allclose(state[key].numpy(), ref, rtol=1e-5, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("pooling", [False, True])
def test_unet_3d_options_match_flax(pooling):
    """Max-pooling instead of strided down-sampling (with align_corners
    False on the way up), zero padding and GroupNorm."""
    jmodel, variables, model, x = _pair("unet_3d", "residual", True, pooling=pooling,
                                        pad_mode="zeros", norm_mode="gn",
                                        act_mode="relu")
    jout = jmodel.apply(variables, jnp.asarray(_nhwc(x)))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert rel_fro(_nhwc(out.numpy()), jout) <= FWD_REL_FRO


def _legacy_criterion(pkg):
    """WeightedBCEWithLogitsLoss plus DiceLoss on sigmoid, for target 0."""
    return pkg(target_opt=["0"],
               loss_opt=[["WeightedBCEWithLogitsLoss", "DiceLoss"]],
               output_act=[["none", "sigmoid"]], loss_weight=[[1.0, 0.5]])


def test_unet_3d_gradients_match_flax():
    jmodel, variables, model, x = _pair("unet_3d", "residual", True, seed=1,
                                        out_channel=1, isotropy=(False, False, True))
    target = (np.random.RandomState(2).rand(*x.shape[:1], 1, *x.shape[2:]) > 0.5
              ).astype(np.float32)
    jcrit = _legacy_criterion(JaxCriterion)

    def jloss(params):
        out, _ = jmodel.apply(dict(variables, params=params), jnp.asarray(_nhwc(x)),
                              mutable=["batch_stats"])
        return jcrit(jnp.moveaxis(out, -1, 1), [jnp.asarray(target)])[0]

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    total, terms = _legacy_criterion(LegacyCriterion)(model(torch.from_numpy(x)),
                                                      [torch.from_numpy(target)])
    total.backward()
    assert set(terms) == {"0_WeightedBCEWithLogitsLoss_0", "0_DiceLoss_0"}
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-5)
    grads = dict(model.named_parameters())
    for path, g in _flatten(jax.tree_util.tree_map(np.asarray, dict(jgrads))):
        key = legacy_torch_key("params", path)
        ref = np.array(g)
        ref = np.moveaxis(ref, (-1, -2), (0, 1)) if ref.ndim >= 3 else (
            ref.T if ref.ndim == 2 else ref)
        assert rel_fro(grads[key].grad.numpy(), ref) <= GRAD_REL_FRO, key


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((5, 7), (9, 13)), ((9, 13), (5, 7)),
                                     ((3, 4, 5), (5, 8, 9)), ((4, 8, 8), (1, 4, 4)),
                                     ((6, 6), (6, 1))])
def test_linear_resize_matches_jax(src, dst, align_corners):
    """F.interpolate, and the per-axis path where an axis shrinks to one
    sample under align_corners, against the JAX function."""
    x = np.random.RandomState(0).randn(2, 3, *src).astype(np.float32)
    ref = jax_blocks.linear_resize(jnp.asarray(_nhwc(x)), dst, align_corners)
    out = linear_resize(torch.from_numpy(x), dst, align_corners)
    np.testing.assert_allclose(_nhwc(out.numpy()), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", UNETS)
def test_build_architecture_matches_jax(arch):
    """``build_architecture`` passes JAX's kwargs (FILTERS, ISOTROPY,
    BLOCK_TYPE, sync_bn -> bn, ...): the JAX model's variables fill the
    port model exactly."""
    cfgs = []
    for defaults in (jax_cfg_defaults, get_cfg_defaults):
        cfg = defaults()
        cfg.MODEL.ARCHITECTURE = arch
        cfg.MODEL.IN_PLANES, cfg.MODEL.OUT_PLANES = 1, 3
        cfg.MODEL.FILTERS = list(FILTERS)
        cfg.MODEL.ISOTROPY = list(ISOTROPY)
        cfg.MODEL.BLOCK_TYPE = "residual_se"
        cfgs.append(cfg)
    jmodel = jax_build_architecture(cfgs[0], train=False)
    rank = _rank(arch)
    x = np.zeros((1,) + (4, 16, 16)[3 - rank:] + (1,), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.key(0), x))
    model = build_architecture(cfgs[1], torch.Generator().manual_seed(0))
    assert isinstance(model, UNet) and model.spatial_rank == rank
    load_flax_legacy_variables(model, {c: dict(t) for c, t in variables.items()})


# named when these five raised NotImplementedError; each builds its port
# class now, held to JAX's build_architecture on the bridged weights
@pytest.mark.parametrize("arch,cls", [
    ("fpn_3d", FPN3D), ("deeplabv3a", DeepLabV3), ("deeplabv3b", DeepLabV3),
    ("deeplabv3c", DeepLabV3), ("unet_residual_3d", UNetResidual3D)],
    ids=["fpn_3d", "deeplabv3a", "deeplabv3b", "deeplabv3c", "unet_residual_3d"])
def test_unported_legacy_names_raise(arch, cls):
    """JAX's kwargs (FILTERS, BLOCKS, ISOTROPY, BACKBONES, AUX_OUT,
    EMBEDDING, ...; DeepLab at ResNet-50's depth): the eval forward of the
    port's model equals JAX's on the same variables."""
    cfgs = []
    for defaults in (jax_cfg_defaults, get_cfg_defaults):
        cfg = defaults()
        cfg.MODEL.ARCHITECTURE = arch
        cfg.MODEL.IN_PLANES, cfg.MODEL.OUT_PLANES = 1, 2
        cfg.MODEL.FILTERS = [4, 6, 8, 10, 12]
        cfg.MODEL.BLOCKS = [1, 2, 1, 1]
        cfg.MODEL.AUX_OUT = True
        cfg.MODEL.INPUT_SIZE = [4, 16, 16]
        cfgs.append(cfg)
    shape = (1, 1, 17, 15) if arch.startswith("deeplab") else (1, 1, 4, 16, 16)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jmodel = jax_build_architecture(cfgs[0], train=False)
    variables = flax_variables(jmodel, x)
    model = build_architecture(cfgs[1], torch.Generator().manual_seed(0))
    assert type(model) is cls
    check_pair(jmodel, variables, model, x, False)


def test_legacy_bridge_rejects_missing_and_extra_keys():
    _, variables, model, _ = _pair("unet_2d", "residual", False)
    params = dict(variables["params"])
    params.pop("conv_out")
    with pytest.raises(KeyError, match="conv_out"):
        load_flax_legacy_variables(model, dict(variables, params=params))
    extra = dict(variables["params"], stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_flax_legacy_variables(model, dict(variables, params=extra))
