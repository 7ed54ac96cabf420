"""The bf16 recipe's dtype flow against the JAX package's (ROADMAP §C.18).

The tiny config of ``tests/test_torch_slice.py`` in ``bfloat16`` with the
recipe's SyncBN heads, at 64x64, weights carried across by
``load_flax_variables``.  One eager JAX forward (eval mode) records, through
``flax.linen.intercept_methods``, the inputs and output of every module the
tests read; the port's module then runs on JAX's own input to it, under the
port's autocast region, so errors do not compound from stage to stage.

* ``ref_point_head`` and the first ``controller`` call (f32 MLPs in JAX)
  agree within 1e-6 rel-Fro; ``sem_logits`` (an f32 conv in JAX) on the
  composed forward within 1e-3;
* every recorded module returns JAX's dtype, and the port's dtype map does
  not depend on the autocast op lists (its norms and heads fix their
  dtypes themselves);
* the backbone blocks, the encoder, the FPN and every decoder layer give
  JAX's dtype and agree within 4 bf16 ULP (at the stage's scale, see
  :func:`ulp_share`) on at least 99.9% of their elements.  One ULP is the
  floor: XLA rounds a bf16 convolution's product before the bias add, the
  port fuses it;
* one composed bf16 train step: JAX's output dtypes, and the losses within
  ``LOSS_RTOL`` of JAX's up to the first attention-mask flip, within
  ``FLIP_RTOL`` after it;
* the LayerNorms of Swin-T, the transformer-encoder FPN and the DETR
  predictor (ROADMAP §C.20) at ``tests/test_torch_alt_components.py``'s
  tiny configs in bf16: JAX's dtype in the composed forward's dtype map,
  and each on JAX's own input within ``LN_REL_FRO``.

The images are the same f32 arrays on both sides: JAX's f16 host transfer
(§C.19) belongs to its trainer, not to ``PCTransModel``.
"""

import re
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.models import ModelConfig as JaxConfig
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_torch.config import ModelConfig
from pctrans_torch.models import PCTransModel
from pctrans_torch.models.pctrans import module_dtypes
from pctrans_torch.ops.resize import resize_bilinear
from pctrans_torch.weights import load_flax_variables, torch_key
from test_torch_alt_components import COMBOS as ALT_COMBOS
from test_torch_alt_components import TINY as ALT_TINY
from test_torch_alt_components import _init as alt_init
from test_torch_slice import _randomize

torch.set_num_threads(1)

TINY = dict(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10, nheads=4,
            dim_feedforward=64, enc_layers=2, dec_layers=3, backbone_depth=14,
            dtype="bfloat16", head_norm="SyncBN")
HW = (64, 64)
HEAD_REL_FRO = 1e-6
SEM_REL_FRO = 1e-3
ULPS, SHARE = 4, 0.999

# JAX module path -> the port's module name
STAGES = {f"backbone/res{k}_block0": f"backbone.res{k}.0" for k in range(2, 6)}
STAGES.update({f"pixel_decoder/{a}{i}": f"pixel_decoder.{a}.{i}"
               for a in ("input_proj", "input_gn") for i in range(3)})
for i in range(TINY["enc_layers"]):
    STAGES[f"pixel_decoder/encoder_layer{i}"] = f"pixel_decoder.encoder_layer.{i}"
    for sub in ("self_attn", "norm1", "norm2"):
        STAGES[f"pixel_decoder/encoder_layer{i}/{sub}"] = \
            f"pixel_decoder.encoder_layer.{i}.{sub}"
STAGES.update({"pixel_decoder/adapter0": "pixel_decoder.adapter.0",
               "pixel_decoder/layer0": "pixel_decoder.layer.0"})
for name in ("ref_point_head", "query_scale", "point_embed", "controller",
             "mask_head", "sem_logits", "decoder_norm", "seg_head0", "seg_head1"):
    port = name.replace("seg_head", "seg_head.") if name.startswith("seg") else name
    STAGES[f"predictor/{name}"] = f"predictor.{port}"
for i in range(TINY["dec_layers"]):
    for j, t, norm in (("cross", "cross_layers", "norm2"), ("self", "self_layers", "norm1"),
                       ("ffn", "ffn_layers", "norm")):
        STAGES[f"predictor/{j}{i}"] = f"predictor.{t}.{i}"
        STAGES[f"predictor/{j}{i}/{norm}"] = f"predictor.{t}.{i}.{norm}"
# modules over maps: NHWC on the JAX side, NCHW in the port
NHWC = re.compile(r"^backbone/|/(input_proj\d|input_gn\d|adapter0|layer0|seg_head\d|"
                  r"sem_logits|mask_head)$")


def _nhwc(path):
    return NHWC.search(path) is not None


def _to_torch(a, path):
    t = torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if np.asarray(a).dtype.name == "bfloat16" else torch.float32)
    return t.permute(0, 3, 1, 2) if t.ndim == 4 and _nhwc(path) else t


def _to_numpy(t, path):
    t = t.detach()
    if t.ndim == 4 and _nhwc(path):
        t = t.permute(0, 2, 3, 1)
    return t.float().numpy()


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def ulp_share(port, ref, ulps=ULPS):
    """Share of elements within ``ulps`` bf16 ULPs of the reference.  The
    ULP is bf16's spacing (8 significant bits) at the larger of |ref| and
    the tensor's RMS: an element far below the RMS is a sum whose terms
    cancelled (a conv output near zero, a LayerNorm output near the mean),
    and carries the rounding of those terms, not of its own size."""
    ref = np.asarray(ref, np.float32)
    port = np.asarray(port, np.float32)
    rms = np.sqrt(np.mean(np.square(ref, dtype=np.float64)))
    scale = np.maximum(np.maximum(np.abs(ref), rms), 2.0 ** -126)
    return float((np.abs(port - ref) <= ulps * 2.0 ** (np.floor(np.log2(scale)) - 7)).mean())


def _record(model, variables, images, **kw):
    """Eager JAX apply; {path: [(args, kwargs, out), ...]} for STAGES."""
    rec = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            path = "/".join(context.module.path)
            if path in STAGES:
                rec.setdefault(path, []).append(
                    jax.tree_util.tree_map(np.asarray, (args, kwargs, out)))
        return out

    with fnn.intercept_methods(interceptor):
        out = model.apply(variables, jnp.asarray(images), **kw)
    return rec, out


def _jax_dtypes(out):
    return ",".join(str(np.asarray(l).dtype) for l in jax.tree_util.tree_leaves(out)
                    if np.issubdtype(np.asarray(l).dtype, np.floating)
                    or np.asarray(l).dtype.name == "bfloat16")


def build_run():
    # remat changes no arithmetic; without it the recorded values are concrete
    jmodel = JaxModel(config=JaxConfig(**TINY, remat=False), train=False)
    rng = np.random.RandomState(0)
    images = rng.randn(2, *HW, 3).astype(np.float32)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, *HW, 3)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c, rng)
                 for c, t in variables.items()}
    rec, jout = _record(jmodel, variables, images)
    model = PCTransModel(ModelConfig(**TINY)).eval()
    load_flax_variables(model, variables)
    with torch.no_grad():
        tout = model(torch.from_numpy(images))
    dtypes = module_dtypes(model, torch.from_numpy(images))
    return types.SimpleNamespace(images=images, variables=variables, rec=rec,
                                 jout=jax.tree_util.tree_map(np.asarray, jout),
                                 model=model, tout=tout, dtypes=dtypes)


@pytest.fixture(scope="module")
def run():
    return build_run()


def _port_call(run, path, call=0):
    """The port's module on JAX's recorded input; (port out, JAX out)."""
    args, kwargs, out = run.rec[path][call]
    module = run.model.get_submodule(STAGES[path])
    targs = [_to_torch(a, path) if isinstance(a, np.ndarray)
             else tuple(tuple(int(v) for v in s) for s in a)    # spatial shapes
             for a in args]
    if path.startswith("predictor/cross"):
        targs = targs[:6]                       # is_first is the port's own field
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        tout = module(*targs)
    return tout, out


@pytest.mark.parametrize("path", ["predictor/ref_point_head", "predictor/controller"])
def test_f32_heads_match_jax(run, path):
    tout, jout = _port_call(run, path)
    assert tout.dtype == torch.float32 and jout.dtype == np.float32
    assert rel_fro(tout.numpy(), jout) <= HEAD_REL_FRO


def test_composed_reference_points_and_first_render_weights(run):
    """On the composed forward, ``ref_point_head`` reads parameters only, so
    the initial reference points match JAX's within 1e-6."""
    q = run.model.predictor.query_embed[None].expand(2, -1, -1)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        ref = torch.sigmoid(run.model.predictor.ref_point_head(q))
        params = run.model.predictor.controller(
            run.model.predictor.query_feat[None].expand(2, -1, -1))
    _, _, jref = run.rec["predictor/ref_point_head"][0]
    _, _, jparams = run.rec["predictor/controller"][0]
    assert rel_fro(torch.logit(ref, 0).numpy(), jref) <= HEAD_REL_FRO
    assert rel_fro(params.numpy(), jparams) <= HEAD_REL_FRO


def test_sem_logits_match_jax(run):
    t, j = run.tout["sem_mask"], run.jout["sem_mask"]
    assert t.dtype == torch.float32 and j.dtype == np.float32
    assert rel_fro(t.numpy(), j) <= SEM_REL_FRO
    tout, jout = _port_call(run, "predictor/sem_logits")
    assert rel_fro(_to_numpy(tout, "predictor/sem_logits"), jout) <= HEAD_REL_FRO


def test_stage_dtypes_match_jax(run):
    """Every recorded JAX module's output dtypes against the port's dtype
    map of the composed forward."""
    assert set(run.rec) == set(STAGES)
    for path, calls in run.rec.items():
        want = "|".join(dict.fromkeys(_jax_dtypes(out) for _, _, out in calls))
        assert run.dtypes[STAGES[path]] == want, path
    assert run.tout["mask_features"].dtype == torch.float32
    assert run.tout["pred_masks"].dtype == torch.bfloat16
    assert run.tout["query_emb"].dtype == torch.float32


def test_dtype_map_is_fixed_by_the_modules(run):
    """The norms, the MLP heads and ``sem_logits`` return the same dtypes
    whether autocast would cast them or not: each runs with autocast off
    and fixes its own output dtype.  So CPU autocast (GroupNorm/LayerNorm
    in bf16) and CUDA autocast (both in f32) give the same map; the card's
    map is held to the CPU's by ``chip_smoke.py`` phase 6."""
    from pctrans_torch.models.layers import MLP, BatchNorm, GroupNorm, LayerNorm

    x = torch.randn(2, 32, 4, 4).to(torch.bfloat16)
    for autocast in (False, True):
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                             enabled=autocast):
            assert GroupNorm(8, 32)(x).dtype == torch.float32
            assert GroupNorm(8, 32, keep_dtype=True)(x).dtype == torch.bfloat16
            assert LayerNorm(4)(x).dtype == torch.float32
            assert LayerNorm(4, keep_dtype=True)(x).dtype == torch.bfloat16
            assert BatchNorm(32).eval()(x).dtype == torch.float32
            assert BatchNorm(32).train()(x).dtype == torch.float32
            assert MLP(4, 8, 2, 2)(x).dtype == torch.float32
    names = {n for n, m in run.model.named_modules()
             if isinstance(m, (GroupNorm, LayerNorm, BatchNorm, MLP))}
    assert {n for n, m in run.model.named_modules()
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))} <= names


@pytest.mark.parametrize("path", [p for p in STAGES if not p.startswith(
    ("predictor/ref_point_head", "predictor/controller", "predictor/query_scale",
     "predictor/point_embed"))])
def test_stage_within_bf16_ulps(run, path):
    """Each stage on JAX's own input: within 4 bf16 ULP on >= 99.9% of its
    elements."""
    for call in range(len(run.rec[path])):
        tout, jout = _port_call(run, path, call)
        touts = [tout[k] for k in sorted(tout)] if isinstance(tout, dict) else [tout]
        jouts = [jout[k] for k in sorted(jout)] if isinstance(jout, dict) else [jout]
        for t, j in zip(touts, jouts):
            assert str(t.dtype) == f"torch.{np.asarray(j).dtype}", path
            share = ulp_share(_to_numpy(t, path), np.asarray(j, np.float32))
            assert share >= SHARE, f"{path} call {call}: {share:.5f}"


# ------------------------------------------------------- composed train step
# bf16 on both sides: each projection rounds its output (one bf16 ULP is
# 3.9e-3 relative), the render's bf16 products differ by their summation
# order, and the losses reduce over masks of ~1e3 pixels per query; the
# gradient norm sums over every parameter
LOSS_RTOL = 1e-2          # terms of masks before the first attention-mask flip
FLIP_RTOL = 5e-2          # the others
MASK_TERM = re.compile(r"^loss_(?:dice|mask)_(\d+)$")


def _attn_flips(masks_a, masks_b):
    """Attention-mask bits (sigmoid < 0.5 at the next layer's level) that
    differ, per mask layer (``chip_smoke.py``'s ``attn_mask_flips``)."""
    sizes = [(HW[0] // s, HW[1] // s) for s in (32, 16, 8)]    # res5, res4, res3
    flips = []
    for i, (a, b) in enumerate(zip(masks_a, masks_b)):
        size = sizes[(i + 1) % 3]
        fa = torch.sigmoid(resize_bilinear(torch.from_numpy(np.asarray(a, np.float32)),
                                           size)) < 0.5
        fb = torch.sigmoid(resize_bilinear(b.float(), size)) < 0.5
        flips.append(int((fa != fb).sum()))
    return flips


@pytest.fixture(scope="module")
def train():
    import copy

    from pctrans_tpu.engine.solver import build_optimizer as jax_build_optimizer
    from pctrans_tpu.engine.state import TrainState
    from pctrans_tpu.engine.state import make_train_step as jax_make_train_step
    from pctrans_tpu.config import get_cfg_defaults
    from pctrans_tpu.losses import CriterionConfig as JaxCriterionConfig
    from pctrans_tpu.losses import SetCriterion as JaxCriterion
    from pctrans_torch.engine.solver import (build_lr_scheduler, build_optimizer,
                                             build_solver_config)
    from pctrans_torch.engine.train_step import make_train_step
    from pctrans_torch.losses.criterion import CriterionConfig, SetCriterion
    from test_torch_train_step import CRIT, G, _batch, _reid_draws

    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(config=jcfg, train=True)
    batch = _batch()
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, *HW, 3)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c,
                               np.random.RandomState(1))
                 for c, t in variables.items()}
    cfg = get_cfg_defaults()
    tx = jax_build_optimizer(cfg, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       frozen=variables.get("frozen", {}),
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state=tx.init(variables["params"]))
    step = jax.jit(jax_make_train_step(jcfg, JaxCriterion(JaxCriterionConfig(**CRIT)),
                                       tx, max_instances=G))
    rng_key = jax.random.key(0)
    _, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng_key)
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, mutable=["batch_stats"])[0])(
        variables, jnp.asarray(batch["image"]))

    model = PCTransModel(ModelConfig(**TINY))
    load_flax_variables(model, variables)
    with torch.no_grad():
        tout = copy.deepcopy(model).train()(torch.from_numpy(batch["image"]))
    solver = build_solver_config(cfg)
    opt = build_optimizer(model, solver)
    t_metrics = make_train_step(model, SetCriterion(CriterionConfig(**CRIT)), opt,
                                build_lr_scheduler(opt, solver), G)(
        batch, reid_uniform=torch.from_numpy(_reid_draws(rng_key, TINY["num_queries"])))
    masks = lambda out: list(out["aux_masks"]) + [out["pred_masks"]]
    return types.SimpleNamespace(
        j_metrics={k: float(v) for k, v in metrics.items()},
        t_metrics={k: float(v) for k, v in t_metrics.items()},
        flips=_attn_flips(masks(jout)[:-1], masks(tout)[:-1]),
        jout=jax.tree_util.tree_map(np.asarray, jout), tout=tout)


def test_bf16_train_step_losses_match_jax(train):
    """One bf16 train step.  Every output of the train-mode forward carries
    JAX's dtype.  A flipped attention-mask bit lets a query attend elsewhere
    in the next decoder layer, so, as ``chip_smoke.py`` does, the terms of
    the masks up to the first flipped one (and the pixel-level ``loss_sem``
    and ``loss_emb``) are held at ``LOSS_RTOL``; the rest, the total among
    them, at ``FLIP_RTOL``.  This seed flips 15 of 320 bits of mask 1 and 4
    of 1,280 of mask 2; the largest term apart was ``loss_reid_query``,
    1.2e-2."""
    for k, j in train.jout.items():
        for a, b in zip(jax.tree_util.tree_leaves(j), jax.tree_util.tree_leaves(
                train.tout[k])):
            assert str(b.dtype) == f"torch.{np.asarray(a).dtype}", k
    first = next((i for i, f in enumerate(train.flips) if f), len(train.flips))
    print("attention-mask bits flipped per layer:", train.flips)
    assert set(train.t_metrics) == set(train.j_metrics)
    for k, v in train.j_metrics.items():
        m = MASK_TERM.match(k)
        held = k in ("loss_sem", "loss_emb") or (m is not None and int(m.group(1)) <= first)
        rel = abs(train.t_metrics[k] - v) / abs(v)
        print(f"{k}: JAX {v:.6g}, port {train.t_metrics[k]:.6g}, rel {rel:.2e}")
        assert rel <= (LOSS_RTOL if held else FLIP_RTOL), k


# ------------------------------------ Swin-T, the transformer-encoder FPN, DETR
LN_REL_FRO = 1e-5         # f32 statistics on both sides, summed in other orders


@pytest.mark.parametrize("combo", ["swin-msdeform", "r14-tenc-detr"])
def test_alt_layernorms_match_jax(combo):
    """ROADMAP §C.20: JAX's LayerNorms in Swin-T (``swin.py:136-258``), the
    transformer-encoder FPN (``fpn_decoder.py:58-63``) and the DETR
    predictor (``detr_decoder.py:48-112``) carry no dtype, so they return
    f32 under the bf16 recipe.  The port's give f32 in the composed
    forward's dtype map, and each, run on every input JAX's gave it under
    the port's autocast region, returns JAX's dtype within ``LN_REL_FRO``."""
    kw = dict(ALT_TINY, **ALT_COMBOS[combo], dtype="bfloat16")
    jmodel = JaxModel(config=JaxConfig(**kw, remat=False), train=False)
    variables = alt_init(jmodel, jnp.zeros((1, *HW, 3)))
    images = np.random.RandomState(0).randn(2, *HW, 3).astype(np.float32)
    rec = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.LayerNorm) and context.method_name == "__call__":
            rec.setdefault(context.module.path, []).append((np.asarray(args[0]),
                                                            np.asarray(out)))
        return out

    with fnn.intercept_methods(interceptor):
        jmodel.apply(variables, jnp.asarray(images))
    model = PCTransModel(ModelConfig(**kw)).eval()
    load_flax_variables(model, variables)
    dtypes = module_dtypes(model, torch.from_numpy(images))
    owners = {"pixel_decoder", "predictor"} | ({"backbone"} if "swin" in combo else set())
    assert {p[0] for p in rec} == owners, sorted(rec)
    for path, calls in rec.items():
        name = torch_key("params", (*path, "scale"), variables["params"])[:-len(".weight")]
        assert dtypes[name] == "|".join(dict.fromkeys(str(o.dtype) for _, o in calls)), name
        module = model.get_submodule(name)
        for x, out in calls:
            with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
                y = module(_to_torch(x, ""))
            assert str(y.dtype) == f"torch.{out.dtype}", name
            if y.dtype == torch.bfloat16:          # the MSDeformAttn encoder's
                assert ulp_share(y.float().numpy(), out) >= SHARE, name
            else:
                assert rel_fro(y.numpy(), out) <= LN_REL_FRO, name
