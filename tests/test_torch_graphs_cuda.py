"""The eval forward's CUDA-graph replay (``models/graphs.py``) on the card,
at both recipes' benchmark shapes (CVPPP 4 x 530x500, Q=100; BBBC
2 x 520x696, Q=300) with random weights:

* the replayed eval step's u8 masks and statistics are bit-equal to the
  eager eval step's, TOP_K and full Q;
* ``Evaluator._label_pipeline``'s labels equal the serial
  ``predict_labels``' with graphs on;
* a forward hook of the model fires on every replay with the replayed
  outputs; outputs outlive the next replay;
* a module attribute of ``dynamic_mask_render`` patched after the capture
  is called once per render on replay, and the kernels' ``.launches``
  count per forward as in the eager forward;
* a parameter replaced by a new tensor causes a new capture; an in-place
  ``load_state_dict`` gives the new weights' outputs without one.

Needs a CUDA card; skips without one.  On the card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py
"""

import numpy as np
import pytest
import torch

import pctrans_torch.models.transformer_decoder as transformer_decoder
from pctrans_torch.config import BBBC_RECIPE, CVPPP_RECIPE
from pctrans_torch.data.synthetic import make_blob_image
from pctrans_torch.engine.eval_step import make_eval_step
from pctrans_torch.engine.evaluator import THRESHOLDS, Evaluator
from pctrans_torch.models import PCTransModel, graphs
from pctrans_torch.ops.msdeform import ms_deform_attn
from pctrans_torch.ops.render import dynamic_mask_render
from pctrans_torch.utils import tracing

pytestmark = pytest.mark.cuda

# recipe -> (config, batch, image size, TOP_K, dataset)
CELLS = {"cvppp": (CVPPP_RECIPE, 4, (530, 500), 50, "cvppp"),
         "bbbc": (BBBC_RECIPE, 2, (520, 696), 160, "bbbc")}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(config, dev, seed=0):
    model = PCTransModel(config, generator=torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def _scenes(n, batch, hw, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        items = [make_blob_image(rng, hw) for _ in range(batch)]
        yield {"image": np.stack([i for i, _ in items]),
               "label": np.stack([l for _, l in items])}


def _images(batch, hw, dev, seed):
    return torch.from_numpy(next(_scenes(1, batch, hw, seed))["image"]).to(dev)


class eager:
    """The model's forward eagerly while open: a submodule's forward hook
    is one of the things the replay cannot keep."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        self.hook = self.model.backbone.register_forward_hook(lambda *a: None)

    def __exit__(self, *exc):
        self.hook.remove()


def _counted(fn):
    """``fn()`` inside a span: (its result, the graph counters it added)."""
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("eval.dispatch", key=0):
            out = fn()
    finally:
        tracing.disable()
    counts = {name: n for name, _, _, n in tracing.table()["counts"]
              if name.startswith("graph_")}
    tracing.reset()
    return out, counts


@pytest.mark.parametrize("top_k", ["top_k", "full"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_replayed_eval_step_is_bit_equal_to_the_eager_one(dev, cell, top_k):
    config, batch, hw, k, dataset = CELLS[cell]
    model = _model(config, dev)
    step = make_eval_step(model, k if top_k == "top_k" else None, THRESHOLDS[dataset],
                          with_stats=True)
    first, counts = _counted(lambda: step(_images(batch, hw, dev, 0)))
    assert counts == {"graph_captures": 1}
    for seed in (1, 2):
        x = _images(batch, hw, dev, seed)
        got, counts = _counted(lambda: step(x))
        assert counts == {"graph_replays": 1}
        with eager(model):
            want = step(x)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("cell", list(CELLS))
def test_label_pipeline_equals_serial_labels_with_graphs(dev, cell):
    config, batch, hw, k, dataset = CELLS[cell]
    ev = Evaluator(_model(config, dev), top_k=k, dataset=dataset)
    batches = list(_scenes(3, batch, hw, seed=5))
    serial = [ev.predict_labels(b["image"]) for b in batches]
    piped = [labels for _, labels in ev._label_pipeline(batches)]
    assert len(piped) == len(serial)
    for a, b in zip(piped, serial):
        np.testing.assert_array_equal(a, b)


def test_hooks_see_every_replay_and_outputs_outlive_the_next(dev):
    config, batch, hw, _, _ = CELLS["cvppp"]
    model = _model(config, dev)
    seen = []
    model.register_forward_hook(lambda m, args, out: seen.append(out))
    xs = [_images(batch, hw, dev, seed) for seed in range(4)]
    with torch.inference_mode():
        outs = [model(x) for x in xs]
        assert len(seen) == len(xs)
        with eager(model):
            wants = [model(x)["pred_masks"] for x in xs]
    for out, hooked, want in zip(outs, seen, wants):
        assert hooked is out
        assert torch.equal(out["pred_masks"], want)


def test_patched_render_and_launch_counts_per_forward(dev, monkeypatch):
    config, batch, hw, _, _ = CELLS["cvppp"]
    model = _model(config, dev)
    x = _images(batch, hw, dev, 0)
    with torch.inference_mode():
        model(x)                                   # the capture
        calls = []

        def counted(*args, **kwargs):
            calls.append(1)
            return dynamic_mask_render(*args, **kwargs)
        monkeypatch.setattr(transformer_decoder, "dynamic_mask_render", counted)
        launches = []
        for run in ("replay", "eager"):
            ms_deform_attn.launches = dynamic_mask_render.launches = 0
            calls.clear()
            if run == "eager":
                with eager(model):
                    model(x)
            else:
                model(x)
            launches.append((ms_deform_attn.launches, dynamic_mask_render.launches,
                             len(calls)))
    renders = config.dec_layers + 1
    assert launches == [(config.enc_layers, renders, renders)] * 2


def test_new_storage_recaptures_and_in_place_loads_do_not(dev):
    config, batch, hw, _, _ = CELLS["cvppp"]
    model = _model(config, dev)
    other = _model(config, dev, seed=1)
    x = _images(batch, hw, dev, 0)
    forward = torch.inference_mode()(lambda m: m(x))
    _counted(lambda: forward(model))
    model.load_state_dict(other.state_dict())              # in place
    out, counts = _counted(lambda: forward(model))
    assert counts == {"graph_replays": 1}
    assert torch.equal(out["pred_masks"], forward(other)["pred_masks"])
    norm = model.predictor.decoder_norm
    norm.weight = torch.nn.Parameter(norm.weight.detach() * 2)
    out, counts = _counted(lambda: forward(model))
    assert counts == {"graph_captures": 1}
    with eager(model):
        want = forward(model)
    assert torch.equal(out["pred_masks"], want["pred_masks"])
    _, counts = _counted(lambda: forward(model))
    assert counts == {"graph_replays": 1}
    assert len(graphs._GRAPHS[model].shapes) == 1
