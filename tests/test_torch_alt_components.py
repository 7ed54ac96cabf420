"""The port's alternative MaskFormer components against the JAX package, f32
on the CPU, with weights carried across by the bridge and inputs from a
numpy seed: the FPN and transformer-encoder pixel decoders, the DETR
predictor, both per-pixel heads, the MSDeformAttn pixel decoder with and
without ``fpn_legacy_swap``, then ``PCTransModel`` and its eval-step masks
for four combinations at ``tests/test_torch_slice.py``'s config and
tolerance, the config mapping of ``MODEL.SWIN`` and ``FPN_LEGACY_SWAP``,
the optimizer's parameter groups and the bridge's errors on the new trees.

The JAX variables' shapes come from ``jax.eval_shape`` of the module's
init (a traced init, no compile) and their values from a numpy seed (see
``_init``), every leaf nonzero, so every path of the bridge carries data.
"""

import dataclasses
import math
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pctrans_tpu.config import CfgNode as JaxCfgNode
from pctrans_tpu.config import get_cfg_defaults as jax_cfg_defaults
from pctrans_tpu.engine.solver import _is_norm_or_bias_path
from pctrans_tpu.engine.state import make_eval_step as jax_make_eval_step
from pctrans_tpu.models import ModelConfig as JaxConfig
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_tpu.models import build_model_config as jax_build_model_config
from pctrans_tpu.models.detr_decoder import StandardTransformerDecoder as JaxDETR
from pctrans_tpu.models.fpn_decoder import BasePixelDecoder as JaxBase
from pctrans_tpu.models.fpn_decoder import TransformerEncoderPixelDecoder as JaxTEnc
from pctrans_tpu.models.per_pixel import PerPixelBaselineHead as JaxPerPixel
from pctrans_tpu.models.per_pixel import PerPixelBaselinePlusHead as JaxPerPixelPlus
from pctrans_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder as JaxMSDA
from pctrans_torch.config import CfgNode, ModelConfig, build_model_config, get_cfg_defaults
from pctrans_torch.engine.eval_step import make_eval_step
from pctrans_torch.engine.solver import parameter_groups
from pctrans_torch.models import (BasePixelDecoder, PCTransModel, PerPixelBaselineHead,
                                  PerPixelBaselinePlusHead, StandardTransformerDecoder,
                                  TransformerEncoderPixelDecoder, build_architecture)
from pctrans_torch.models.legacy import UNet
from pctrans_torch.models.per_pixel import init_head
from pctrans_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from pctrans_torch.ops.resize import resize_bilinear
from pctrans_torch.weights import _flatten, load_flax_variables, torch_key

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4          # tests/test_torch_slice.py's
# below the recipe's 0.69, so that every combination's random logits (peaks
# 0.2-0.6 for the plain FPN's) clear it somewhere
TOP_K, THRESHOLD = 4, 0.6
LOGIT_T = math.log(THRESHOLD / (1 - THRESHOLD))
HW = (64, 64)
TINY = dict(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10, nheads=4,
            dim_feedforward=64, enc_layers=1, dec_layers=3, backbone_depth=14)
SWIN = dict(backbone_name="D2SwinTransformer", swin_embed_dim=16,
            swin_depths=(2, 2, 2, 2), swin_num_heads=(2, 2, 4, 4))
COMBOS = {
    "swin-msdeform": dict(SWIN, head_norm="GN"),
    "r14-fpn": dict(pixel_decoder_name="BasePixelDecoder", head_norm="SyncBN"),
    "r14-tenc-detr": dict(pixel_decoder_name="TransformerEncoderPixelDecoder",
                          transformer_decoder_name="StandardTransformerDecoder",
                          head_norm="SyncBN"),
    "swin-legacy-swap": dict(SWIN, fpn_legacy_swap=True, head_norm="GN"),
}
# backbone maps at 64x64 for the standalone modules: (grid, channels)
FEATURES = {"res2": (16, 12), "res3": (8, 16), "res4": (4, 20), "res5": (2, 24)}


def _init(module, *args, seed=1):
    """The module's variables drawn from a numpy seed at the scales of
    JAX's init after ``test_torch_slice._randomize``: kernels at Xavier's
    variance (the sampling-offset and attention-weight kernels, zero at
    init, at 0.05), norm scales near 1, biases at 0.05, embeddings at 1,
    relative-position tables at 0.1, BatchNorm statistics nonzero."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        keys = [k.key for k in path]
        name, shape = keys[-1], leaf.shape
        if name == "kernel" and keys[-2] in ("sampling_offsets", "attention_weights"):
            a = 0.05 * rng.randn(*shape)
        elif name == "kernel":      # Xavier's variance
            a = rng.randn(*shape) * np.sqrt(2.0 / (np.prod(shape[:-1]) + shape[-1]))
        elif name == "scale":
            a = 1.0 + 0.05 * rng.randn(*shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            a = 0.05 * rng.randn(*shape)
        elif name == "relative_position_bias_table":
            a = 0.1 * rng.randn(*shape)
        else:                       # query and level embeddings
            a = rng.randn(*shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    return {c: jax.tree_util.tree_map_with_path(draw, dict(t)) for c, t in shapes.items()}


def _features(seed=2):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(2, n, n, c).astype(np.float32) for k, (n, c) in FEATURES.items()}


def _nchw(feats):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}


def _close(ours, ref, nchw=True):
    ours = ours.detach()
    if nchw:
        ours = ours.permute(0, 2, 3, 1)
    ref = np.asarray(ref)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=RTOL, atol=ATOL)


def _port(module, variables):
    load_flax_variables(module, variables)
    return module.eval()


IN_CH = {k: c for k, (_, c) in FEATURES.items()}


# ------------------------------------------------------- standalone modules
@pytest.mark.parametrize("name", ["BasePixelDecoder", "TransformerEncoderPixelDecoder"])
def test_fpn_pixel_decoders_match_jax(name):
    feats = _features()
    if name == "BasePixelDecoder":
        jmod = JaxBase(conv_dim=32, mask_dim=8, norm="SyncBN", train=False)
        ours = BasePixelDecoder(IN_CH, 32, 8, "SyncBN")
    else:
        jmod = JaxTEnc(conv_dim=32, mask_dim=8, norm="SyncBN", nheads=4, d_ffn=64,
                       transformer_enc_layers=2, train=False)
        ours = TransformerEncoderPixelDecoder(IN_CH, 32, 8, "SyncBN", 4, 64, 2)
    variables = _init(jmod, feats)
    jmask, jenc, jms = jax.jit(jmod.apply)(variables, feats)
    with torch.no_grad():
        mask, enc, ms = _port(ours, variables)(_nchw(feats))
    _close(mask, jmask)
    assert mask.shape[1:] == (8, 16, 16)
    assert len(ms) == len(jms) == 3
    for a, b in zip(ms, jms):
        _close(a, b)
    assert (enc is None) == (jenc is None) == (name == "BasePixelDecoder")
    if enc is not None:
        _close(enc, jenc)


def test_detr_predictor_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 5, 24).astype(np.float32)
    mf = rng.randn(2, 16, 20, 8).astype(np.float32)
    jmod = JaxDETR(hidden_dim=32, num_queries=10, nheads=4, dim_feedforward=64,
                   enc_layers=1, dec_layers=3, mask_dim=8, train=False)
    variables = _init(jmod, x, mf)
    jout = jax.jit(jmod.apply)(variables, x, mf)
    ours = _port(StandardTransformerDecoder(24, 32, 10, 4, 64, enc_layers=1, dec_layers=3,
                                            mask_dim=8), variables)
    with torch.no_grad():
        tout = ours(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(mf).permute(0, 3, 1, 2))
    assert set(tout) == set(jout) == {"pred_logits", "pred_masks", "aux_masks", "aux_logits"}
    assert len(tout["aux_masks"]) == len(tout["aux_logits"]) == 2
    for key in ("pred_logits", "pred_masks"):
        _close(tout[key], jout[key], nchw=False)
    for key in ("aux_masks", "aux_logits"):
        for a, b in zip(tout[key], jout[key]):
            _close(a, b, nchw=False)
    assert tout["pred_masks"].shape == (2, 10, 16, 20)


@pytest.mark.parametrize("plus", [False, True], ids=["baseline", "plus"])
def test_per_pixel_heads_match_jax(plus):
    feats = _features(4)
    if plus:
        jmod = JaxPerPixelPlus(num_classes=3, conv_dim=32, mask_dim=8, norm="GN",
                               hidden_dim=32, nheads=4, d_ffn=64, enc_layers=1,
                               dec_layers=2, train=False)
        ours = PerPixelBaselinePlusHead(IN_CH, 3, 32, 8, "GN", hidden_dim=32, nheads=4,
                                        d_ffn=64, enc_layers=1, dec_layers=2)
    else:
        jmod = JaxPerPixel(num_classes=3, conv_dim=32, mask_dim=8, norm="GN", train=False)
        ours = PerPixelBaselineHead(IN_CH, 3, 32, 8, "GN")
    variables = _init(jmod, feats)
    jout = jax.jit(jmod.apply)(variables, feats)
    with torch.no_grad():
        tout = _port(ours, variables)(_nchw(feats))
    if plus:
        assert set(tout) == set(jout) == {"pred_masks", "aux_masks"}
        _close(tout["pred_masks"], jout["pred_masks"], nchw=False)
        assert tout["pred_masks"].shape == (2, 3, 16, 16) and len(tout["aux_masks"]) == 1
        _close(tout["aux_masks"][0], jout["aux_masks"][0], nchw=False)
    else:
        _close(tout, jout, nchw=False)
        assert tout.shape == (2, 3, 16, 16)


def test_per_pixel_plus_needs_the_encoder_features():
    with pytest.raises(ValueError, match="TransformerEncoderPixelDecoder"):
        PerPixelBaselinePlusHead(IN_CH, pixel_decoder_name="BasePixelDecoder")


def test_per_pixel_predictor_init_is_msra():
    """``init_head`` gives the baseline's 1x1 predictor flax's
    variance_scaling(2, fan_out, truncated_normal): std sqrt(2 / fan_out),
    cut at two of the uncorrected deviations."""
    head = PerPixelBaselineHead(IN_CH, num_classes=1, mask_dim=4096, norm="GN")
    init_head(head, torch.Generator().manual_seed(0))
    w = head.predictor.weight.detach()
    assert abs(float(w.std()) - math.sqrt(2.0)) < 0.05
    assert float(w.abs().max()) <= 2 * math.sqrt(2.0) / 0.87962566103423978
    assert not head.predictor.bias.any()


@pytest.mark.parametrize("swap", [False, True], ids=["upstream", "legacy-swap"])
def test_msdeform_pixel_decoder_legacy_swap_matches_jax(swap):
    feats = _features(5)
    jmod = JaxMSDA(conv_dim=32, norm="GN", transformer_layers=1, n_heads=4, n_points=4,
                   d_ffn=64, fpn_legacy_swap=swap, train=False)
    variables = _init(jmod, feats)
    jmask, jtop, jms = jax.jit(jmod.apply)(variables, feats)
    ours = _port(MSDeformAttnPixelDecoder(IN_CH, 32, "GN", 1, 4, 4, d_ffn=64,
                                          fpn_legacy_swap=swap), variables)
    with torch.no_grad():
        mask, top, ms = ours(_nchw(feats))
    _close(mask, jmask)
    _close(top, jtop)
    for a, b in zip(ms, jms):
        _close(a, b)
    assert mask.shape[-2:] == ((8, 8) if swap else (16, 16))


# ------------------------------------------------------------ PCTransModel
@pytest.fixture(scope="module", params=list(COMBOS))
def run(request):
    kw = dict(TINY, **COMBOS[request.param])
    jmodel = JaxModel(config=JaxConfig(**kw), train=False)
    variables = _init(jmodel, jnp.zeros((1, *HW, 3)))
    images = np.random.RandomState(0).randn(2, *HW, 3).astype(np.float32)
    eval_step = jax_make_eval_step(JaxConfig(**kw), top_k=TOP_K, threshold=THRESHOLD)

    @jax.jit
    def jax_run(variables, images):
        state = types.SimpleNamespace(params=variables["params"],
                                      frozen=variables.get("frozen", {}),
                                      batch_stats=variables.get("batch_stats", {}))
        return jmodel.apply(variables, images), eval_step(state, images)

    jout, (jmasks, jpeaks) = jax.tree_util.tree_map(
        np.asarray, jax_run(variables, jnp.asarray(images)))
    model = PCTransModel(ModelConfig(**kw)).eval()
    load_flax_variables(model, variables)
    with torch.no_grad():
        tout = model(torch.from_numpy(images))
    tmasks, tpeaks = make_eval_step(model, TOP_K, THRESHOLD)(torch.from_numpy(images))
    return types.SimpleNamespace(name=request.param, kw=kw, variables=variables,
                                 model=model, jout=jout, tout=tout, jmasks=jmasks,
                                 jpeaks=jpeaks, tmasks=tmasks.numpy(), tpeaks=tpeaks.numpy())


def test_model_forward_matches_jax(run):
    assert set(run.tout) == set(run.jout)
    for key, ref in run.jout.items():
        ours = run.tout[key]
        if ref is None:
            assert ours is None, key
            continue
        pairs = zip(ours, ref) if isinstance(ref, list) else [(ours, ref)]
        for a, b in pairs:
            assert tuple(a.shape) == b.shape, key
            np.testing.assert_allclose(a.float().numpy(), b, rtol=RTOL, atol=ATOL,
                                       err_msg=key)
    grid = (8, 8) if run.kw.get("fpn_legacy_swap") else (16, 16)
    assert run.tout["pred_masks"].shape[-2:] == grid


def test_model_eval_step_masks_match_jax(run):
    np.testing.assert_allclose(run.tpeaks, run.jpeaks, rtol=RTOL, atol=ATOL)
    assert run.tmasks.shape == run.jmasks.shape == (2, TOP_K) + HW
    pred = run.tout["pred_masks"]
    idx = torch.topk(pred.amax(dim=(2, 3)), TOP_K, dim=1).indices
    kept = torch.take_along_dim(pred, idx[:, :, None, None], dim=1)
    logits = resize_bilinear(kept.float(), HW).numpy()
    differ = run.tmasks != run.jmasks
    assert (np.abs(logits[differ] - LOGIT_T) <= 1e-3).all()
    assert differ.sum() <= 1e-4 * differ.size
    assert run.tmasks.any() and (run.tmasks == 0).any()


def _assert_jax_labels(params, model):
    """Every parameter's weight-decay group is the label JAX's
    ``_is_norm_or_bias_path`` gives its flax leaf, through the bridge's
    key map."""
    labels = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map_with_path(lambda p, _: _is_norm_or_bias_path(p), params))[0]
    ref = {}
    for path, label in labels:
        ref.setdefault(label, set()).add(
            torch_key("params", tuple(k.key for k in path), params))
    ours = {k: set(v) for k, v in parameter_groups(model).items() if v}
    assert ours == ref


def test_parameter_groups_are_the_jax_optimizer_labels(run):
    _assert_jax_labels(run.variables["params"], run.model)
    if "swin" in run.name:
        groups = parameter_groups(run.model)
        assert "backbone.blocks.0.0.attn.relative_position_bias_table" in groups["kernel"]
        assert "backbone.patch_norm.weight" in groups["norm"]


def test_recipe_parameter_groups_are_the_jax_optimizer_labels():
    """The recipe's tree (R-14, MSDeformAttn, the PCTrans predictor, SyncBN
    heads): the decoder's ``input_gn`` biases are ``bias`` in JAX (their
    path holds neither "norm" nor "bn"), their scales ``norm``."""
    kw = dict(TINY, head_norm="SyncBN")
    params = _init(JaxModel(config=JaxConfig(**kw), train=False),
                   jnp.zeros((1, *HW, 3)))["params"]
    model = PCTransModel(ModelConfig(**kw))
    _assert_jax_labels(params, model)
    groups = parameter_groups(model)
    assert "pixel_decoder.input_gn.0.bias" in groups["bias"]
    assert "pixel_decoder.input_gn.0.weight" in groups["norm"]


def _replace(tree, path, value):
    """``tree`` with the leaf at ``path`` replaced (copies along the path)."""
    if len(path) == 1:
        return dict(tree, **{path[0]: value})
    return dict(tree, **{path[0]: _replace(tree[path[0]], path[1:], value)})


def test_bridge_rejects_a_stray_backbone_leaf_and_a_misshapen_kernel(run):
    """A backbone leaf with no torch entry, and a kernel of the wrong shape
    (a 3-D attention kernel where the tree has one), raise with the flax
    path in the message."""
    params = run.variables["params"]
    stray = _replace(params, ("backbone", "stray"), {"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="params/backbone/stray/kernel"):
        load_flax_variables(run.model, dict(run.variables, params=stray))
    kernels = [path for path, a in _flatten(params) if path[-1] == "kernel"]
    path = next((p for p, a in _flatten(params) if p[-1] == "kernel" and a.ndim == 3),
                kernels[0])
    assert (len(_get(params, path).shape) == 3) == (run.name == "r14-tenc-detr")
    bad = _replace(params, path, np.zeros((3,) * len(_get(params, path).shape), np.float32))
    with pytest.raises(ValueError, match="params/" + "/".join(path)):
        load_flax_variables(run.model, dict(run.variables, params=bad))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("backbone", ["build_resnet_backbone", "D2SwinTransformer"])
@pytest.mark.parametrize("decoder,predictor,swap", [
    ("MSDeformAttnPixelDecoder", "MultiScaleMaskedTransformerDecoder", False),
    ("MSDeformAttnPixelDecoder", "MultiScaleMaskedTransformerDecoder", True),
    ("MSDeformAttnPixelDecoder", "StandardTransformerDecoder", False),
    ("BasePixelDecoder", "MultiScaleMaskedTransformerDecoder", False),
    ("TransformerEncoderPixelDecoder", "MultiScaleMaskedTransformerDecoder", False),
    ("TransformerEncoderPixelDecoder", "StandardTransformerDecoder", False)])
def test_every_combination_builds_and_runs(backbone, decoder, predictor, swap):
    """Every combination ``pctrans_tpu/models/pctrans.py:171-263`` builds
    (the DETR predictor over the plain FPN raises, below), on the port
    alone: finite masks on the mask features' grid, the eval step's u8
    masks at the input size."""
    kw = dict(TINY, head_norm="GN", backbone_name=backbone, pixel_decoder_name=decoder,
              transformer_decoder_name=predictor, fpn_legacy_swap=swap)
    if backbone == "D2SwinTransformer":
        kw.update(swin_embed_dim=16, swin_num_heads=(2, 2, 4, 4))
    model = PCTransModel(ModelConfig(**kw), generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 60, 76, 3).astype(np.float32))
    with torch.no_grad():
        out = model.eval()(images)
    grid = (8, 10) if swap else (15, 19)
    assert out["pred_masks"].shape == (2, 10) + grid
    assert len(out["aux_masks"]) == TINY["dec_layers"]
    assert out["mask_features"].shape[1:3] == grid
    assert torch.isfinite(out["pred_masks"]).all()
    assert ("pred_logits" in out) == (predictor == "StandardTransformerDecoder")
    masks, _ = make_eval_step(model, TOP_K, THRESHOLD)(images)
    assert masks.shape == (2, TOP_K, 60, 76) and masks.dtype == torch.uint8


# ----------------------------------------------------------------- config
def _with_alternatives(cfg, node):
    cfg.MODEL.BACKBONE.NAME = "D2SwinTransformer"
    cfg.MODEL.SEM_SEG_HEAD.FPN_LEGACY_SWAP = True
    cfg.MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME = "TransformerEncoderPixelDecoder"
    cfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME = "StandardTransformerDecoder"
    cfg.MODEL.SWIN = node({"EMBED_DIM": 128, "DEPTHS": [2, 2, 18, 2],
                           "NUM_HEADS": [4, 8, 16, 32], "WINDOW_SIZE": 12,
                           "DROP_PATH_RATE": 0.2})
    return cfg


def test_build_model_config_reads_swin_and_legacy_swap_as_jax():
    ours = build_model_config(_with_alternatives(get_cfg_defaults(), CfgNode))
    ref = jax_build_model_config(_with_alternatives(jax_cfg_defaults(), JaxCfgNode))
    for f in dataclasses.fields(ModelConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert (ours.swin_embed_dim, ours.swin_depths, ours.swin_window_size,
            ours.fpn_legacy_swap) == (128, (2, 2, 18, 2), 12, True)
    defaults = build_model_config(get_cfg_defaults())
    assert (defaults.swin_embed_dim, defaults.swin_depths, defaults.swin_num_heads,
            defaults.swin_window_size, defaults.swin_drop_path) == \
        (96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 0.3)


@pytest.mark.parametrize("field,value", [
    ("backbone_name", "build_vit_backbone"), ("pixel_decoder_name", "FPN"),
    ("transformer_decoder_name", "DETR"), ("sem_seg_head_name", "PerPixelBaselineHead")])
def test_unknown_components_raise(field, value):
    with pytest.raises(ValueError, match=re.escape(repr(value))):
        PCTransModel(ModelConfig(**TINY, **{field: value}))


def test_detr_over_the_plain_fpn_raises():
    with pytest.raises(ValueError, match="BasePixelDecoder has none"):
        PCTransModel(ModelConfig(**TINY, pixel_decoder_name="BasePixelDecoder",
                                 transformer_decoder_name="StandardTransformerDecoder"))


# the ids are the cases' ids from before the U-Nets were ported
@pytest.mark.parametrize("arch,expect", [
    ("MaskFormer", PCTransModel), ("unet_3d", UNet), ("deeplabv3b", NotImplementedError),
    ("no_such_net", ValueError)], ids=["MaskFormer-None", "unet_3d-NotImplementedError",
                                       "deeplabv3b-NotImplementedError",
                                       "no_such_net-ValueError"])
def test_build_architecture_dispatch(arch, expect):
    cfg = get_cfg_defaults()
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.ARCHITECTURE = arch
    if issubclass(expect, nn.Module):
        assert isinstance(build_architecture(cfg), expect)
    else:
        with pytest.raises(expect, match="slice 6b" if expect is NotImplementedError else arch):
            build_architecture(cfg)
