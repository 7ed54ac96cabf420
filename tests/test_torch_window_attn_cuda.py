"""K6, Swin's fused window attention (``csrc/window_attn.cu``), on the card
at Swin-L's shapes (embed 192, heads 6/12/24/48, window 12) on a
4 x 530x500 batch, the ``cvppp-swinl`` cell's:

* K6 against its twin, plain and shifted, at each stage's windows (133x125
  padded to 144x132 ... 17x16 padded to 24x24) and at a window clamped to
  a 10x11 map, both against the same arithmetic in f64 from the same bf16
  inputs;
* a Swin-L PCTrans eval step replayed from CUDA graphs bit-equal to the
  eager one, with K6 serving all 24 blocks of every forward (its launch
  count and the ``window_attn_kernel`` counter);
* the twin and K6 forwards of the whole model within bf16's rounding.

Needs a CUDA card; skips without one.  On the card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_window_attn_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pctrans_torch.config import CVPPP_RECIPE
from pctrans_torch.data.synthetic import make_blob_image
from pctrans_torch.engine.eval_step import make_eval_step
from pctrans_torch.models import PCTransModel
from pctrans_torch.ops import _build
from pctrans_torch.ops.window_attn import (clamped_position_index, shift_attn_mask,
                                           window_attention)
from pctrans_torch.utils import tracing

pytestmark = pytest.mark.cuda

SWINL = dataclasses.replace(CVPPP_RECIPE, backbone_name="D2SwinTransformer",
                            swin_embed_dim=192, swin_depths=(2, 2, 18, 2),
                            swin_num_heads=(6, 12, 24, 48), swin_window_size=12)
WINDOW = 12
# Swin-L's stages at 530x500: (token map, channels, heads); and a map no
# larger than the window, which runs one window of its smaller side
STAGES = {"res2": ((133, 125), 192, 6), "res3": ((67, 63), 384, 12),
          "res4": ((34, 32), 768, 24), "res5": ((17, 16), 1536, 48),
          "clamped": ((10, 11), 192, 6)}
BATCH, HW = 4, (530, 500)
# K6 and the twin round the same f32 values to bf16 at three places (S, P,
# the output) after sums in other orders, so a value near a rounding
# boundary lands one bf16 step (2^-8 relative) apart now and then: their
# gap stays under half a step at the output's scale.  Neither is the
# other's reference: each is held to f64 arithmetic on the same bf16
# inputs, K6 no farther than the twin and a tenth of a step more.
TWIN_GAP = 2.0 ** -9
F64_SLACK = 2.0 ** -8 / 10


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K6 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def attention_inputs(hw, C, H, shifted, dev, seed=0):
    """qkv and the table for one block of a ``BATCH`` of ``hw`` maps, as
    ``SwinBlock`` hands them over: (qkv, table, heads, ws, table window,
    shift, grid, scale)."""
    ws = WINDOW if min(hw) > WINDOW else min(hw)
    shift = WINDOW // 2 if shifted and min(hw) > WINDOW else 0
    grid = (math.ceil(hw[0] / ws), math.ceil(hw[1] / ws))
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(BATCH * grid[0] * grid[1], ws * ws, 3 * C, generator=g, device=dev)
    table = torch.randn((2 * WINDOW - 1) ** 2, H, generator=g, device=dev)
    return qkv.bfloat16(), table, H, ws, WINDOW, shift, grid, (C // H) ** -0.5


def f64_attention(qkv, table, H, ws, tws, shift, grid, scale):
    """The twin's arithmetic in f64 from the same bf16 q (scaled in bf16,
    as both round it), k and v."""
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    x = qkv.reshape(Bn, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
    q, k, v = (x[0] * scale).double(), x[1].double(), x[2].double()
    attn = q @ k.transpose(-1, -2)
    idx = clamped_position_index(ws, tws, qkv.device)
    attn = attn + table.double()[idx.reshape(-1)].reshape(N, N, H).permute(2, 0, 1)[None]
    if shift:
        mask = shift_attn_mask(grid[0] * ws, grid[1] * ws, ws, shift, qkv.device).double()
        attn = (attn.reshape(Bn // mask.shape[0], mask.shape[0], H, N, N)
                + mask[None, :, None]).reshape(Bn, H, N, N)
    return (attn.softmax(-1) @ v).transpose(1, 2).reshape(Bn, N, C)


def rel_fro(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage", list(STAGES))
def test_k6_matches_its_twin(dev, stage, shifted):
    args = attention_inputs(*STAGES[stage], shifted, dev)
    with torch.inference_mode():
        got = window_attention(*args)
        twin = window_attention(*args, impl="twin")
        exact = f64_attention(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == twin.shape
    gap, k6_err, twin_err = rel_fro(got, twin), rel_fro(got, exact), rel_fro(twin, exact)
    print(f"{stage} shift {args[5]}: K6-twin {gap:.3e}, K6-f64 {k6_err:.3e}, "
          f"twin-f64 {twin_err:.3e}")
    assert gap <= TWIN_GAP
    assert k6_err <= twin_err + F64_SLACK


def _images(seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(np.stack([make_blob_image(rng, HW)[0] for _ in range(BATCH)]))


@pytest.fixture(scope="module")
def swinl(dev):
    return PCTransModel(SWINL, generator=torch.Generator().manual_seed(0)).to(dev).eval()


def test_replayed_swinl_step_is_bit_equal_to_the_eager_one_with_k6_in_every_block(
        dev, swinl):
    step = make_eval_step(swinl, 50, 0.69, with_stats=True)
    blocks = sum(SWINL.swin_depths)
    step(_images(0).to(dev))                               # the capture
    for seed in (1, 2):
        x = _images(seed).to(dev)
        window_attention.launches = 0
        tracing.reset()
        tracing.enable()
        try:
            with tracing.span("eval.dispatch", key=0):
                got = step(x)
        finally:
            tracing.disable()
        counts = {name: n for name, _, _, n in tracing.table()["counts"]}
        tracing.reset()
        assert counts.get("graph_replays") == 1
        assert counts.get("window_attn_kernel") == blocks
        assert window_attention.launches == blocks
        hook = swinl.backbone.register_forward_hook(lambda *a: None)   # eager
        try:
            want = step(x)
        finally:
            hook.remove()
        assert window_attention.launches == 2 * blocks
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


def test_swinl_forward_with_k6_against_the_twin(dev, swinl):
    x = _images(3).to(dev)
    with torch.inference_mode():
        got = swinl(x)
        with _build.twins():                   # eager, every kernel's twin
            twin = swinl(x)
    gap = rel_fro(got["mask_features"], twin["mask_features"])
    print(f"Swin-L mask features, K6 against the twin: {gap:.3e}")
    # 24 blocks of bf16 activations: each block's rounding flips move the
    # features by a small multiple of bf16's step, far under the benchmark's
    # 0.025 limit on the same number
    assert gap < 2.0 ** -6


@pytest.mark.parametrize("case", ["f32", "head width 64", "a gradient"])
def test_k6_refuses_on_the_card_what_it_cannot_take(dev, case):
    """On a CUDA tensor the wrapper raises rather than fall back to the
    twin: the model chooses the twin explicitly where it wants it."""
    qkv, table, H, ws, tws, shift, grid, scale = attention_inputs(*STAGES["res3"], True, dev)
    if case == "f32":
        qkv = qkv.float()
    elif case == "head width 64":
        H, table = H // 2, table[:, :H // 2].contiguous()
    else:
        table.requires_grad_()
    with pytest.raises(ValueError, match="no backward" if case == "a gradient"
                       else "kernel takes bf16"):
        window_attention(qkv, table, H, ws, tws, shift, grid, scale)


def test_a_swinl_train_step_forward_runs_no_k6(dev, swinl):
    """Training reaches the twin by the module's mode (K6 has no backward)."""
    window_attention.launches = 0
    swinl.train()
    try:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            feats = swinl.backbone(_images(4).to(dev).permute(0, 3, 1, 2)[:1, :, :224, :224])
        feats["res5"].float().sum().backward()
    finally:
        swinl.eval()
        swinl.zero_grad(set_to_none=True)
    assert window_attention.launches == 0
