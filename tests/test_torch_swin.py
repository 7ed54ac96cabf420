"""The port's Swin backbone (``pctrans_torch/models/swin.py``) against the JAX
package's (``pctrans_tpu/models/swin.py``), f32 on the CPU, inputs from a
numpy seed: the window, index and mask helpers, then the whole backbone at
embed 16, depths (2, 2, 2, 2), heads (2, 2, 4, 4), window 7 at 64x64 and
60x76.  Those sizes pad the maps to the window (15x19 -> 21x21), shift
windows with the 0/-100 mask, merge odd maps (15x19 -> 8x10) and clamp the
window where a map is no larger than it (4x4 and 2x2; 4x5 and 2x3), where
JAX's table has the clamped window's size and the bridge places it.  Drop
path's rule is checked on the port alone.

The same at Swin-L's shape, made small: embed 32 with heads (1, 2, 4, 8)
keeps every head 32 wide, depths (2, 2, 18, 2), window 12, at 96x96 (a
24x24 map in 2x2 shifted windows, then maps of 12x12, 6x6 and 3x3 that
clamp the window) and 112x104 (28x26 padded to 36x36).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.models.swin import SwinTransformer as JaxSwin
from pctrans_tpu.models.swin import (_relative_position_index, _shift_attn_mask,
                                     window_partition as jax_partition,
                                     window_reverse as jax_reverse)
from pctrans_torch.models.swin import (SwinBlock, SwinTransformer, drop_path,
                                       relative_position_index, shift_attn_mask,
                                       window_partition, window_reverse)
from pctrans_torch.models.pctrans import init_weights
from pctrans_torch.weights import _flatten, load_flax_variables, torch_key
from test_torch_slice import _randomize

torch.set_num_threads(1)

SWIN = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=7)
# f32 on both sides; LayerNorm statistics and the attention sums are
# accumulated in other orders through 8 blocks
RTOL, ATOL = 1e-4, 1e-4


@pytest.mark.parametrize("hw,ws", [((14, 21), 7), ((8, 12), 4), ((6, 6), 2)])
def test_window_partition_and_reverse_equal_jax(hw, ws):
    x = np.random.RandomState(0).randn(2, *hw, 5).astype(np.float32)
    wins = window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jax_partition(jnp.asarray(x), ws)))
    back = window_reverse(wins, ws, *hw)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_reverse(jnp.asarray(
        wins.numpy()), ws, *hw)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("ws", [2, 4, 7])
def test_relative_position_index_equals_jax(ws):
    np.testing.assert_array_equal(relative_position_index(ws), _relative_position_index(ws))


def test_clamped_index_reads_the_central_offsets():
    """A clamped window w's index into the full window W's table lands on
    the same (dy, dx) offset as its own table's index: the bridge's
    placement of JAX's clamped table."""
    w, W = 4, 7
    own, full = relative_position_index(w), relative_position_index(w, W)
    dy, dx = np.divmod(own, 2 * w - 1)
    np.testing.assert_array_equal(full, (dy + W - w) * (2 * W - 1) + dx + W - w)


@pytest.mark.parametrize("hp,wp,ws,shift", [(14, 14, 7, 3), (14, 21, 7, 3), (21, 21, 7, 3),
                                            (8, 12, 4, 2)])
def test_shift_mask_equals_jax(hp, wp, ws, shift):
    mask = shift_attn_mask(hp, wp, ws, shift)
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), _shift_attn_mask(hp, wp, ws, shift))
    assert set(np.unique(mask.numpy())) == {0.0, -100.0}


SWINL_SMALL = dict(embed_dim=32, depths=(2, 2, 18, 2), num_heads=(1, 2, 4, 8),
                   window_size=12)


def backbones(config, hw):
    """The JAX backbone at ``config`` with randomized variables, the port's
    with them loaded, and both outputs on one batch of two images."""
    jmodel = JaxSwin(**config, train=False)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, *hw, 3)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c,
                               np.random.RandomState(1)) for c, t in variables.items()}
    images = np.random.RandomState(2).randn(2, *hw, 3).astype(np.float32)
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.apply)(variables, images))
    model = SwinTransformer(**config).eval()
    load_flax_variables(model, variables)
    with torch.no_grad():
        tout = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    return hw, variables, model, jout, tout


@pytest.fixture(scope="module", params=[(64, 64), (60, 76)], ids=["64x64", "60x76"])
def run(request):
    return backbones(SWIN, request.param)


@pytest.fixture(scope="module", params=[(96, 96), (112, 104)], ids=["96x96", "112x104"])
def run_swinl(request):
    return backbones(SWINL_SMALL, request.param)


@pytest.mark.parametrize("level", ["res2", "res3", "res4", "res5"])
def test_swinl_shape_matches_jax(run_swinl, level):
    hw, _, model, jout, tout = run_swinl
    ours = tout[level].permute(0, 2, 3, 1).numpy()
    assert ours.shape == jout[level].shape
    assert tout[level].shape[1] == model.channels[level]
    np.testing.assert_allclose(ours, jout[level], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("level", ["res2", "res3", "res4", "res5"])
def test_swin_matches_jax(run, level):
    hw, _, model, jout, tout = run
    ours = tout[level].permute(0, 2, 3, 1).numpy()
    assert ours.shape == jout[level].shape
    assert tout[level].shape[1] == model.channels[level]
    np.testing.assert_allclose(ours, jout[level], rtol=RTOL, atol=ATOL)


def test_swin_grids_and_clamped_tables(run):
    """The stage grids (ceil halving after the patch embed) and the tables
    JAX sized to the clamped windows of the last two stages."""
    hw, variables, _, jout, _ = run
    grids = [tuple(jout[f"res{i}"].shape[1:3]) for i in range(2, 6)]
    expect = [(-(-hw[0] // 4), -(-hw[1] // 4))]
    for _ in range(3):
        expect.append(tuple((n + 1) // 2 for n in expect[-1]))
    assert grids == expect
    tables = [variables["params"][f"layer{i}_block0"]["attn"]["relative_position_bias_table"]
              .shape[0] for i in range(4)]
    assert tables == [169, 169, 49, 9]


def test_swin_bridge_rejects_a_stray_leaf_and_a_bad_table(run):
    _, variables, model, _, _ = run
    params = dict(variables["params"])
    block = dict(params["layer0_block0"])
    block["attn"] = dict(block["attn"], stray=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="params/layer0_block0/attn/stray"):
        load_flax_variables(model, {"params": dict(params, layer0_block0=block)})
    block["attn"] = dict(variables["params"]["layer0_block0"]["attn"],
                         relative_position_bias_table=np.zeros((16, 2), np.float32))
    with pytest.raises(ValueError, match="layer0_block0/attn/relative_position_bias_table"):
        load_flax_variables(model, {"params": dict(params, layer0_block0=block)})


def test_init_follows_the_jax_initializers(run):
    """``init_weights`` gives each Swin tensor the spread of JAX's init
    (LeCun normal for the attention projections and the patch embed,
    truncated N(0, 0.02) for the MLPs, reductions and tables): each
    standard deviation within a factor 1.3 of JAX's on tensors of 500
    values or more, biases zero."""
    _, variables, _, _, _ = run
    holder = torch.nn.Module()
    holder.backbone = SwinTransformer(**SWIN)
    init_weights(holder, torch.Generator().manual_seed(0))
    ours = dict(holder.named_parameters())
    checked = 0
    for path, ref in _flatten(variables["params"]):
        name = torch_key("params", ("backbone",) + path, {})
        t = ours[name].detach()
        if path[-1] == "bias":
            assert not t.any(), name
        elif path[-1] in ("kernel", "relative_position_bias_table") and ref.size >= 500:
            if path[-1] == "relative_position_bias_table" and ref.shape != tuple(t.shape):
                continue                   # JAX's clamped-window tables
            ratio = float(t.std()) / float(np.std(ref))
            assert 1 / 1.3 < ratio < 1.3, (name, ratio)
            checked += 1
    assert checked >= 30


# ------------------------------------------------------------------ drop path
def test_drop_path_keeps_or_drops_each_sample_whole():
    x = torch.randn(64, 5, 3) + 3.0
    g = torch.Generator().manual_seed(0)
    y = drop_path(x, 0.25, g)
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | ~kept.any(1)).all())             # per sample
    rows = kept.all(1)
    torch.testing.assert_close(y[rows], x[rows] / 0.75, rtol=0, atol=0)
    assert 0 < int((~rows).sum()) < 64
    # the same draws from the same seed; the mask is the generator's [B, 1, 1] draw
    draw = torch.rand((64, 1, 1), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(rows, (draw < 0.75).flatten())


def test_drop_path_rates_are_linspace_and_eval_draws_nothing():
    model = SwinTransformer(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                            drop_path_rate=0.3)
    rates = [b.drop_path for stage in model.blocks for b in stage]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 8), rtol=0, atol=0)
    x = torch.randn(2, 3, 32, 32)
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    with torch.no_grad():
        a = model.eval()(x, g)
        assert torch.equal(g.get_state(), state)
        b = model.train()(x, torch.Generator().manual_seed(5))
        c = model.train()(x, torch.Generator().manual_seed(5))
        d = model.train()(x, torch.Generator().manual_seed(6))
    assert torch.equal(b["res5"], c["res5"])
    assert not torch.equal(b["res5"], d["res5"])
    assert not torch.equal(a["res5"], b["res5"])


def test_block_without_drop_path_is_the_same_in_train_and_eval():
    block = SwinBlock(16, 2, 7, shift_size=3, drop_path=0.0)
    x = torch.randn(2, 15 * 19, 16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        torch.testing.assert_close(block.train()(x, (15, 19), g), block.eval()(x, (15, 19)),
                                   rtol=0, atol=0)
