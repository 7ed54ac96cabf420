"""The sync-free forward and where the eval forward's CUDA graphs do not
apply, on the CPU (``models/graphs.py``; the replay itself is tested on
the card by ``tests/test_torch_graphs_cuda.py``).

* After its first call, the forward builds no tensor from host values, in
  every combination of components: the per-call constants (the pixel mean
  and deviation, the encoder's level normalizer, the render's scale,
  Swin's clamped window index, the FPN's nearest-resize indices) are made
  once per shape and device.
* ``state_dict()`` keys are the parameters and persistent buffers, as
  before: the constants are in no module.
* The eval step's and the train forward's outputs are bit-equal to those
  of a forward that builds its constants on every call, as it did before.
* The forward stays eager on the CPU, in train mode, outside
  ``inference_mode``, inside ``_build.twins()`` or with a generator."""

import dataclasses

import pytest
import torch

import pctrans_torch.models.pctrans as pctrans_module
import pctrans_torch.models.pixel_decoder as pixel_decoder
import pctrans_torch.models.transformer_decoder as transformer_decoder
from pctrans_torch.engine.eval_step import make_eval_step
from pctrans_torch.models import PCTransModel, graphs
from pctrans_torch.ops import _build
from test_torch_evaluator import HW, TINY

torch.set_num_threads(1)

SWIN = dataclasses.replace(TINY, backbone_name="D2SwinTransformer", swin_embed_dim=16,
                           swin_depths=(2, 2, 2, 2), swin_num_heads=(2, 2, 4, 4))
CONFIGS = {"recipe": TINY, "recipe-bf16": dataclasses.replace(TINY, dtype="bfloat16"),
           "swin": SWIN,
           "fpn": dataclasses.replace(TINY, pixel_decoder_name="BasePixelDecoder"),
           "tenc-detr": dataclasses.replace(
               TINY, pixel_decoder_name="TransformerEncoderPixelDecoder",
               transformer_decoder_name="StandardTransformerDecoder"),
           "legacy-swap": dataclasses.replace(TINY, fpn_legacy_swap=True)}
# the tiny recipe's keys before the constants moved out of the forward
TINY_STATE_KEYS = 259


def _model(config):
    return PCTransModel(config, generator=torch.Generator().manual_seed(0)).eval()


def _images(seed=1, batch=2):
    return torch.rand((batch,) + HW + (3,), generator=torch.Generator().manual_seed(seed)) * 255


def _outputs(model, mode, images):
    if mode == "eval":
        return make_eval_step(model, 4, 0.6, with_stats=True)(images)
    model.train()
    return model(images)


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return []


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_builds_no_tensor_after_its_first_call(name, mode, monkeypatch):
    model = _model(CONFIGS[name])
    _outputs(model, mode, _images())

    def refused(*args, **kwargs):
        raise AssertionError("a tensor built from host values inside the forward")
    arange = torch.arange

    def arange_on_a_device(*args, **kwargs):
        if kwargs.get("device") is None:
            refused()
        return arange(*args, **kwargs)
    monkeypatch.setattr(torch, "tensor", refused)
    monkeypatch.setattr(torch, "from_numpy", refused)
    monkeypatch.setattr(torch, "arange", arange_on_a_device)
    _outputs(model, mode, _images(seed=2))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_keys_are_the_parameters_and_persistent_buffers(name):
    model = _model(CONFIGS[name])
    keys = list(model.state_dict())
    persistent = [n for n, _ in model.named_buffers()
                  if n.rsplit(".", 1)[-1] not in
                  model.get_submodule(n.rpartition(".")[0])._non_persistent_buffers_set]
    assert sorted(keys) == sorted([n for n, _ in model.named_parameters()] + persistent)
    assert not [k for k in keys
                if k.rsplit(".", 1)[-1] in ("pixel_mean", "pixel_std", "normalizer")]
    if name.startswith("recipe"):
        assert len(keys) == TINY_STATE_KEYS
    _model(CONFIGS[name]).load_state_dict(model.state_dict(), strict=True)


def _per_call_constant(values, device, dtype=torch.float32):
    return torch.tensor(values, dtype=dtype, device=device)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", ["recipe", "recipe-bf16"])
def test_outputs_equal_a_forward_that_builds_its_constants_per_call(name, mode,
                                                                     monkeypatch):
    images = _images()
    got = _flat(_outputs(_model(CONFIGS[name]), mode, images))
    for module in (pctrans_module, pixel_decoder, transformer_decoder):
        monkeypatch.setattr(module, "device_constant", _per_call_constant)
    want = _flat(_outputs(_model(CONFIGS[name]), mode, images))
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.stride() == b.stride()
        assert torch.equal(a, b)


def test_why_eager_names_each_reason():
    model = _model(TINY)
    x = _images()
    with torch.inference_mode():
        assert graphs.why_eager(model, x, None) == "a cpu input"
        with _build.twins():
            assert graphs.why_eager(model, x, None) == "inside _build.twins()"
        assert graphs.why_eager(model, x, torch.Generator()) == "a generator"
        model.train()
        assert graphs.why_eager(model, x, None) == "train mode"
    model.eval()
    with torch.no_grad():
        assert graphs.why_eager(model, x, None) == "not under inference_mode"


def test_why_eager_names_the_twins_scope_until_it_ends():
    """An eval forward inside ``_build.twins()`` stays eager whatever else
    holds (the scope is named before a generator or the input's device);
    the reason goes with the scope."""
    model = _model(TINY)
    x = _images()
    with torch.inference_mode():
        with _build.twins():
            with _build.twins():
                assert graphs.why_eager(model, x, torch.Generator()) == "inside _build.twins()"
            assert graphs.why_eager(model, x, None) == "inside _build.twins()"
        assert graphs.why_eager(model, x, torch.Generator()) == "a generator"


@pytest.mark.parametrize("case", ["eval_step", "train", "twin"])
def test_forward_stays_eager_on_the_cpu(case, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("graphs on the CPU")
    monkeypatch.setattr(graphs, "run", refused)
    model = _model(TINY)
    x = _images()
    if case == "eval_step":
        masks, stats = make_eval_step(model, 4, 0.6, with_stats=True)(x)
        assert masks.shape == (2, 4) + HW and stats.shape == (2, 4, 6)
    else:
        with torch.inference_mode():
            if case == "train":
                model.train()
                out = model(x)
            else:
                with _build.twins():
                    out = model(x)
        assert out["pred_masks"].shape[:2] == (2, TINY.num_queries)
    assert graphs._GRAPHS.get(model) is None


def test_constants_made_under_inference_mode_serve_a_backward():
    """An eval (under ``inference_mode``) makes the shared constants first;
    a train forward then saves them for its backward."""
    model = _model(TINY)
    make_eval_step(model, 4, 0.6)(_images())
    model.train()
    out = model(_images(seed=2))
    (out["pred_masks"].float().mean() + out["mask_features"].mean()).backward()
    assert model.pixel_decoder.encoder_layer[0].self_attn.sampling_offsets.weight.grad is not None


def test_observed_state_keeps_in_place_loads_and_sees_new_storage():
    model = _model(TINY)
    parts = graphs._parts(model)
    state, hooked = graphs._observe(parts)
    assert not hooked and all(p[0] is not model for p in parts)
    model.load_state_dict(_model(TINY).state_dict())        # in place
    assert graphs._observe(parts) == (state, False)
    norm = model.predictor.decoder_norm
    norm.weight = torch.nn.Parameter(norm.weight.detach().clone())
    assert graphs._observe(parts)[0] != state
    state = graphs._observe(graphs._parts(model))[0]
    model.predictor.decoder_norm = type(norm)(norm.weight.shape[0])
    assert graphs._observe(parts)[0] != state


@pytest.mark.parametrize("where", ["submodule hook", "submodule pre-hook",
                                   "submodule forward", "model hook"])
def test_observed_hooks_on_submodules_ask_for_the_eager_forward(where):
    model = _model(TINY)
    if where == "submodule hook":
        model.backbone.register_forward_hook(lambda *a: None)
    elif where == "submodule pre-hook":
        model.pixel_decoder.register_forward_pre_hook(lambda *a: None)
    elif where == "submodule forward":
        model.predictor.forward = model.predictor.forward
    else:
        # Module.__call__ runs the model's own hooks around the replay
        model.register_forward_hook(lambda *a: None)
    assert graphs._observe(graphs._parts(model))[1] == (where != "model hook")
