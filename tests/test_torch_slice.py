"""The PyTorch port's eval slice against the JAX package on the tiny config
(``__graft_entry__.py:74-78``: depth-14 backbone, 1 encoder layer, 3 decoder
layers, 10 queries) at 64x64, with the same weights and images.

The JAX variables come from ``PCTransModel.init``; parameters that init
leaves at zero get small random values, and the FrozenBN and BatchNorm
statistics random ones, so every path of the weight bridge carries data.
One jitted JAX run per head norm gives the model outputs and the
``make_eval_step(top_k=4, threshold=0.69)`` masks.
"""

import dataclasses
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.engine.state import make_eval_step as jax_make_eval_step
from pctrans_tpu.inference.postprocess import instance_inference_cvppp
from pctrans_tpu.models import ModelConfig as JaxConfig
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_torch.config import CVPPP_RECIPE, ModelConfig, build_model_config
from pctrans_torch.engine.eval_step import make_eval_step
from pctrans_torch.models import PCTransModel
from pctrans_torch.models.resnet import ResNet
from pctrans_torch.ops.resize import resize_bilinear
from pctrans_torch.weights import load_flax_variables

torch.set_num_threads(1)

TINY = dict(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10, nheads=4,
            dim_feedforward=64, enc_layers=1, dec_layers=3, backbone_depth=14)
HW = (64, 64)
TOP_K, THRESHOLD = 4, 0.69
LOGIT_T = math.log(THRESHOLD / (1 - THRESHOLD))
# f32 on both sides; summation orders differ (the JAX CPU path samples with
# the hat-matmul, the twin with grid_sample; LayerNorm and GroupNorm
# variances are computed differently), amplified through 3 decoder layers
# on logits of magnitude ~20.
RTOL, ATOL = 1e-4, 1e-4


def _randomize(tree, col, rng):
    out = {}
    for k, a in tree.items():
        if isinstance(a, dict):
            out[k] = _randomize(a, col, rng)
            continue
        a = np.array(a, np.float32)
        if col == "params" and not a.any():
            a = a + 0.05 * rng.randn(*a.shape).astype(np.float32)
        elif col in ("frozen", "batch_stats"):
            a = (rng.uniform(0.5, 1.5, a.shape) if k in ("var", "scale")
                 else 0.1 * rng.randn(*a.shape)).astype(np.float32)
        out[k] = a
    return out


@pytest.fixture(scope="module", params=["GN", "SyncBN"])
def run(request):
    kw = dict(TINY, head_norm=request.param)
    jmodel = JaxModel(config=JaxConfig(**kw), train=False)
    rng = np.random.RandomState(0)
    images = rng.randn(2, *HW, 3).astype(np.float32)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, *HW, 3)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c, rng)
                 for c, t in variables.items()}
    eval_step = jax_make_eval_step(JaxConfig(**kw), top_k=TOP_K,
                                   threshold=THRESHOLD)
    stats_step = jax_make_eval_step(JaxConfig(**kw), top_k=TOP_K,
                                    threshold=THRESHOLD, with_stats=True)

    @jax.jit
    def jax_run(variables, images):
        state = types.SimpleNamespace(params=variables["params"],
                                      frozen=variables.get("frozen", {}),
                                      batch_stats=variables.get("batch_stats", {}))
        return (jmodel.apply(variables, images), eval_step(state, images),
                stats_step(state, images)[1])

    jout, (jmasks, jpeaks), jstats = jax.tree_util.tree_map(
        np.asarray, jax_run(variables, jnp.asarray(images)))

    model = PCTransModel(ModelConfig(**kw)).eval()
    load_flax_variables(model, variables)
    with torch.no_grad():
        tout = model(torch.from_numpy(images))
    tmasks, tpeaks = make_eval_step(model, TOP_K, THRESHOLD)(torch.from_numpy(images))
    smasks, tstats = make_eval_step(model, TOP_K, THRESHOLD, with_stats=True)(
        torch.from_numpy(images))
    assert torch.equal(smasks, tmasks)
    return types.SimpleNamespace(images=images, variables=variables, model=model,
                                 jout=jout, tout=tout, jmasks=jmasks, jpeaks=jpeaks,
                                 tmasks=tmasks.numpy(), tpeaks=tpeaks.numpy(),
                                 jstats=jstats, tstats=tstats.numpy())


KEYS = ["pred_masks", "aux_masks", "reference_points", "aux_reference_points",
        "query_emb", "sem_mask", "mask_features"]


@pytest.mark.parametrize("key", KEYS)
def test_forward_matches_jax(run, key):
    j, t = run.jout[key], run.tout[key]
    if isinstance(j, list):
        assert len(j) == len(t)
    else:
        j, t = [j], [t]
    for a, b in zip(j, t):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.float().numpy(), a, rtol=RTOL, atol=ATOL)


def test_no_attention_mask_bit_flips(run):
    """The attention mask (sigmoid < 0.5 at the next level) is discontinuous;
    a flipped bit would change what a query attends to.  This seed has
    none, so the tolerances above measure arithmetic, not a flip."""
    sizes = [(2, 2), (4, 4), (8, 8)]          # res5, res4, res3 at 64x64
    masks_j = run.jout["aux_masks"]
    masks_t = run.tout["aux_masks"]
    for i, (a, b) in enumerate(zip(masks_j, masks_t)):
        size = sizes[i % 3]
        fa = torch.sigmoid(resize_bilinear(torch.from_numpy(np.array(a)), size)) < 0.5
        fb = torch.sigmoid(resize_bilinear(b, size)) < 0.5
        assert int((fa != fb).sum()) == 0, f"layer {i}"


def test_eval_step_masks_match_jax(run):
    np.testing.assert_allclose(run.tpeaks, run.jpeaks, rtol=RTOL, atol=ATOL)
    assert run.tmasks.shape == run.jmasks.shape == (2, TOP_K) + HW
    assert run.tmasks.dtype == np.uint8
    # masks may differ only where the upsampled logit sits at the threshold
    pred = run.tout["pred_masks"]
    idx = torch.topk(pred.amax(dim=(2, 3)), TOP_K, dim=1).indices
    kept = torch.take_along_dim(pred, idx[:, :, None, None], dim=1)
    logits = resize_bilinear(kept, HW).numpy()
    differ = run.tmasks != run.jmasks
    assert (np.abs(logits[differ] - LOGIT_T) <= 1e-3).all()
    assert differ.sum() <= 1e-4 * differ.size
    assert run.tmasks.any() and (run.tmasks == 0).any()


def test_eval_step_stats_match_jax(run):
    """``with_stats``: the packed [B, K, K+2] statistics of each side's
    masks, the counts exact (the masks agree on this seed) and the peak
    logits within the forward's tolerance."""
    assert run.tstats.shape == run.jstats.shape == (2, TOP_K, TOP_K + 2)
    np.testing.assert_array_equal(run.tmasks, run.jmasks)
    np.testing.assert_array_equal(run.tstats[..., :-1], run.jstats[..., :-1])
    np.testing.assert_allclose(run.tstats[..., -1], run.jstats[..., -1], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(run.tstats[..., -1], run.tpeaks)
    flat = run.tmasks.reshape(2, TOP_K, -1).astype(np.int64)
    np.testing.assert_array_equal(run.tstats[..., TOP_K], flat.sum(-1))
    assert run.tstats[..., TOP_K].max() > 0


def test_label_maps_match_jax(run):
    n_instances = 0
    for b in range(run.images.shape[0]):
        lj = instance_inference_cvppp(run.jmasks[b].astype(np.float32), THRESHOLD)
        lt = instance_inference_cvppp(run.tmasks[b].astype(np.float32), THRESHOLD)
        np.testing.assert_array_equal(lt, lj)
        n_instances += int(lj.max())
    assert n_instances > 0


def test_weights_bridge_rejects_missing_and_extra_keys(run):
    model, variables = run.model, run.variables
    missing = {c: dict(t) for c, t in variables.items()}
    params = dict(missing["params"])
    predictor = dict(params["predictor"])
    del predictor["query_feat"]
    params["predictor"] = predictor
    missing["params"] = params
    with pytest.raises(KeyError, match="query_feat"):
        load_flax_variables(model, missing)
    extra = dict(variables)
    extra["params"] = dict(variables["params"], stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="stray"):
        load_flax_variables(model, extra)
    bad = dict(variables)
    bad["params"] = dict(variables["params"],
                         predictor=dict(variables["params"]["predictor"],
                                        query_feat=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(model, bad)


def test_cvppp_recipe_equals_yaml_config():
    from pctrans_tpu.config import load_cfg
    from pctrans_tpu.models import build_model_config as jax_build

    cfg_dir = Path(__file__).resolve().parents[1] / "configs" / "CVPPP"
    base = str(cfg_dir / "CVPPP-PCTrans-Base.yaml")
    exp = str(cfg_dir / "CVPPP-PCTrans.yaml")
    cfg = load_cfg(base, exp)
    assert build_model_config(cfg) == CVPPP_RECIPE
    ref = jax_build(cfg)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(CVPPP_RECIPE, f.name) == getattr(ref, f.name), f.name
    # fields the port does not carry: the JAX graph's train-memory knobs;
    # the Swin fields are carried and equal JAX's (the loop above)
    skipped = {f.name for f in dataclasses.fields(JaxConfig)} - \
        {f.name for f in dataclasses.fields(ModelConfig)}
    assert skipped == {"remat", "remat_policy"}
    assert CVPPP_RECIPE.swin_depths == ref.swin_depths == (2, 2, 6, 2)
    assert CVPPP_RECIPE.pixel_std == (255.0, 255.0, 255.0)
    assert CVPPP_RECIPE.dtype == "bfloat16"


@pytest.mark.parametrize("hw,grids", [
    ((530, 500), [(133, 125), (67, 63), (34, 32), (17, 16)]),
    ((106, 100), [(27, 25), (14, 13), (7, 7), (4, 4)]),
])
def test_resnet_grids_at_odd_sizes(hw, grids):
    """Every stride-2 conv and the max-pool give the JAX grids (torch
    floor arithmetic with symmetric padding); shapes only, on the meta
    device."""
    net = ResNet(depth=50).to("meta")
    out = net(torch.empty(1, 3, *hw, device="meta"))
    assert [tuple(out[k].shape[-2:]) for k in ("res2", "res3", "res4", "res5")] == grids
