"""K6, Swin's fused window attention (``pctrans_torch/csrc/window_attn.cu``),
on the CPU, where it cannot run:

* the kernel's arithmetic rehearsed in numpy (``k6_rehearsal``): its loads
  into mma fragment registers, the m16n8k16 products by PTX's fragment
  layout, the bias and shift mask from each token pair's place, the quad
  reductions of the softmax (the SFU's exp emulated as an f32 2^(x log2 e),
  one reciprocal per row), P repacked in place as the A fragments of P.V
  and the transposed store, held to the twin
  (``ops/window_attn.py``) at Swin-L's window 12 (plain, shifted, padded
  maps), at clamped windows and at Swin-T's window 7;
* the index and region arithmetic against the table index and the shift
  mask, for every window up to 12 and several grids;
* the wrapper's dispatch (CPU tensors take the twin; on a card it launches
  bf16 without a gradient and raises for anything else), the model's
  explicit choice (K6 in eval mode, the twin in train mode and in an f32
  configuration), one K6 call per block of a Swin-L shaped backbone, and
  the reader of Mask2Former's ``MODEL.SWIN`` node.

Change the kernel and ``k6_rehearsal`` together.
"""

import math

import numpy as np
import pytest
import torch

import pctrans_torch.models.swin as swin
from pctrans_torch.config import (CVPPP_RECIPE, CfgNode, build_model_config,
                                  get_cfg_defaults)
from pctrans_torch.config.model import SWIN_FIXED, swin_fields
from pctrans_torch.models import PCTransModel
from pctrans_torch.ops import _build
from pctrans_torch.ops.window_attn import (relative_position_index, shift_attn_mask,
                                           window_attention, window_attention_twin)

torch.set_num_threads(1)

LANE = np.arange(32)
G, T4 = LANE >> 2, LANE & 3
HD = 32
LOG2E = np.float32(1.4426950408889634)


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def a_matrix(regs):
    """PTX's m16n8k16 A fragment: lane registers [32, 4, 2] -> [16, 16]."""
    a = np.zeros((16, 16), np.float64)
    for p in range(4):
        for e in range(2):
            a[G + 8 * (p & 1), T4 * 2 + 8 * (p >> 1) + e] = regs[:, p, e]
    return a


def b_matrix(regs):
    """PTX's m16n8k16 B fragment: lane registers [32, 2, 2] -> [16, 8]."""
    b = np.zeros((16, 8), np.float64)
    for p in range(2):
        for e in range(2):
            b[T4 * 2 + 8 * p + e, G] = regs[:, p, e]
    return b


def mma(acc, a_regs, b_regs):
    """acc [32, 4] f32 (PTX's C layout) += A . B, summed exactly and rounded
    to f32 once per product."""
    c = a_matrix(a_regs) @ b_matrix(b_regs)
    d = np.stack([c[G + 8 * (i >> 1), T4 * 2 + (i & 1)] for i in range(4)], 1)
    return (acc.astype(np.float64) + d).astype(np.float32)


def quad(x, op):
    """The kernel's two shuffles (xor 1, then xor 2) over each quad."""
    x = op(x, x[LANE ^ 1])
    return op(x, x[LANE ^ 2])


def shift_regions(win, grid, ws, shift):
    """The kernel's rule for window ``win`` of ``grid``: whether the shift
    masks along y and x there (the grid's last row and column of windows)
    and the split of each axis, at ``ws - shift``."""
    mask_y = bool(shift) and win // grid[1] == grid[0] - 1
    mask_x = bool(shift) and win % grid[1] == grid[1] - 1
    return mask_y, mask_x, ws - shift


def masked(i_yx, j_yx, rule):
    mask_y, mask_x, cut = rule
    (yi, xi), (yj, xj) = i_yx, j_yx
    return (mask_y & ((yi < cut) != (yj < cut))) | (mask_x & ((xi < cut) != (xj < cut)))


def k6_rehearsal(qkv, table, H, ws, tws, shift, grid, scale):
    """window_attn.cu's arithmetic, step by step, in numpy: qkv [Bn, N, 3C]
    (bf16 values), table [(2t-1)^2, H] -> [Bn, N, C] (bf16 values)."""
    qkv = np.asarray(qkv, np.float32)
    table = np.asarray(table, np.float32)
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    NT = (N + 15) // 16
    T = 2 * tws - 1
    out = np.zeros((Bn, N, C), np.float32)
    for w in range(Bn):
        rule = shift_regions(w % (grid[0] * grid[1]), grid, ws, shift)
        for h in range(H):
            ks = np.zeros((NT * 16, HD), np.float32)
            ks[:N] = qkv[w, :, C + h * HD:C + (h + 1) * HD]
            vt = np.zeros((HD, NT * 16), np.float32)
            vt[:, :N] = qkv[w, :, 2 * C + h * HD:2 * C + (h + 1) * HD].T
            tab = table[:, h]
            for warp in range(NT):
                r0 = warp * 16 + G
                rows = (r0, r0 + 8)
                qa = np.zeros((2, 32, 4, 2), np.float32)
                for kk in range(2):
                    for part in range(4):
                        r = rows[part & 1]
                        c = kk * 16 + (part >> 1) * 8 + T4 * 2
                        for e in range(2):
                            v = np.where(r < N, qkv[w, np.minimum(r, N - 1), h * HD + c + e], 0)
                            qa[kk, :, part, e] = bf16(v.astype(np.float32) * np.float32(scale))
                s = np.zeros((2 * NT, 32, 4), np.float32)
                for j in range(2 * NT):
                    for kk in range(2):
                        b = np.stack([np.stack([ks[j * 8 + G, kk * 16 + T4 * 2 + 8 * p + e]
                                                for e in range(2)], 1) for p in range(2)], 1)
                        s[j] = mma(s[j], qa[kk], b)
                i_yx = [divmod(np.minimum(r, N - 1), ws) for r in rows]
                base = [(y + tws - 1) * T + x + tws - 1 for y, x in i_yx]
                yj, xj = [np.zeros(32, int), np.zeros(32, int)], [T4 * 2, T4 * 2 + 1]
                for j in range(2 * NT):
                    for e in range(2):
                        while (xj[e] >= ws).any():
                            wrap = xj[e] >= ws
                            xj[e] = np.where(wrap, xj[e] - ws, xj[e])
                            yj[e] = yj[e] + wrap
                        key = j * 8 + T4 * 2 + e < N
                        off = yj[e] * T + xj[e]
                        for a in range(2):
                            x = bf16(s[j, :, e + 2 * a]) + tab[np.clip(base[a] - off, 0,
                                                                       T * T - 1)]
                            x = np.where(masked(i_yx[a], (yj[e], xj[e]), rule),
                                         x + np.float32(-100.0), x)
                            s[j, :, e + 2 * a] = np.where(key, x, -np.inf)
                        xj[e] = xj[e] + 8
                mx = [quad(np.max(s[:, :, [2 * a, 2 * a + 1]], axis=(0, 2)), np.maximum)
                      for a in range(2)]
                for e in range(4):            # __expf: 2^(x log2 e) on the SFU
                    s[:, :, e] = np.exp2((s[:, :, e] - mx[e >> 1]) * LOG2E)
                sums = [np.zeros(32, np.float32), np.zeros(32, np.float32)]
                for j in range(2 * NT):
                    for e in range(4):
                        sums[e >> 1] = sums[e >> 1] + s[j, :, e]
                inv = [np.float32(1) / quad(x, np.add) for x in sums]
                o = np.zeros((4, 32, 4), np.float32)
                for kk in range(NT):
                    pa = np.zeros((32, 4, 2), np.float32)
                    for part in range(4):
                        j, a = 2 * kk + (part >> 1), part & 1
                        for e in range(2):
                            pa[:, part, e] = bf16(s[j, :, e + 2 * a] * inv[a])
                    for nt in range(4):
                        b = np.stack([np.stack([vt[nt * 8 + G, kk * 16 + T4 * 2 + 8 * p + e]
                                                for e in range(2)], 1) for p in range(2)], 1)
                        o[nt] = mma(o[nt], pa, b)
                for nt in range(4):
                    for a, r in enumerate(rows):
                        for e in range(2):
                            ok = r < N
                            out[w, r[ok], h * HD + nt * 8 + T4[ok] * 2 + e] = \
                                bf16(o[nt, ok, e + 2 * a])
    return out


def inputs(ws, tws, shift, grid, heads, batch=1, seed=0):
    """bf16 qkv as SwinBlock hands it over and an N(0, 1) table (a trained
    table's scale), for ``batch`` images of ``grid`` windows."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(batch * grid[0] * grid[1], ws * ws, 3 * HD * heads, generator=g)
    table = torch.randn((2 * tws - 1) ** 2, heads, generator=g)
    return qkv.bfloat16(), table, heads, ws, tws, shift, grid, HD ** -0.5


# (window, table window, shift, grid, heads): Swin-L's window 12 plain and
# shifted, a map padded to 2x2 windows, windows clamped to small maps, and
# Swin-T's window 7
CASES = {"w12": (12, 12, 0, (1, 2), 2), "w12-shift": (12, 12, 6, (2, 2), 1),
         "w12-shift-3x1": (12, 12, 6, (3, 1), 1), "clamped-7-of-12": (7, 12, 0, (1, 1), 2),
         "clamped-3-of-12": (3, 12, 0, (1, 1), 3), "w7-shift": (7, 7, 3, (2, 2), 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_k6_arithmetic_rehearsal_matches_the_twin(case):
    args = inputs(*CASES[case])
    with torch.no_grad():
        twin = window_attention_twin(*args).float().numpy()
    got = k6_rehearsal(args[0].float().numpy(), args[1].numpy(), *args[2:])
    # the same roundings after sums in other orders: now and then one bf16
    # step apart, under half a step at the output's scale (the card's gate)
    gap = np.linalg.norm(got - twin) / np.linalg.norm(twin)
    assert gap <= 2.0 ** -9, gap
    assert np.isclose(got, twin, rtol=2.0 ** -7, atol=2.0 ** -7 * np.abs(twin).max()).all()


@pytest.mark.parametrize("tws", [7, 12])
def test_bias_index_by_arithmetic_is_the_table_index(tws):
    for ws in range(1, tws + 1):
        i = np.arange(ws * ws)
        y, x = i // ws, i % ws
        idx = (y[:, None] - y[None] + tws - 1) * (2 * tws - 1) + (x[:, None] - x[None] + tws - 1)
        np.testing.assert_array_equal(idx, relative_position_index(ws, tws))


@pytest.mark.parametrize("ws,shift,grid", [(12, 6, (3, 4)), (12, 6, (1, 2)), (7, 3, (3, 3)),
                                           (4, 2, (2, 5)), (12, 6, (1, 1))])
def test_kernels_shift_rule_is_the_shift_mask(ws, shift, grid):
    want = shift_attn_mask(grid[0] * ws, grid[1] * ws, ws, shift).numpy()
    yx = np.divmod(np.arange(ws * ws), ws)
    for win in range(grid[0] * grid[1]):
        got = masked((yx[0][:, None], yx[1][:, None]), (yx[0][None], yx[1][None]),
                     shift_regions(win, grid, ws, shift))
        np.testing.assert_array_equal(np.where(got, -100.0, 0.0), want[win])


def test_wrapper_takes_the_twin_on_the_cpu_and_refuses_other_impls():
    args = inputs(12, 12, 6, (2, 2), 2, batch=2)
    with torch.no_grad():
        assert torch.equal(window_attention(*args), window_attention_twin(*args))
        assert torch.equal(window_attention(*args, impl="twin"), window_attention_twin(*args))
        with pytest.raises(ValueError, match="impl"):
            window_attention(*args, impl="kernel")


class FakeLibrary:
    """The kernel library's K6 entry point, recording its launches."""

    def __init__(self):
        self.launches = []

    def pctrans_window_attn_fwd(self, *args):
        self.launches.append(args)
        return 0


def test_k6_is_taken_in_bf16_without_a_gradient(monkeypatch):
    """The wrapper as it runs on a card (its device check made to say CUDA,
    the launch recorded): it launches bf16 qkv with heads 32 wide and a
    window of at most 12 where no gradient is needed, and raises for
    anything else rather than fall back."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "use_kernel", lambda t, impl, op: impl is None)
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    qkv, table, *rest = inputs(12, 12, 6, (2, 2), 2)
    with torch.no_grad():
        assert window_attention(qkv, table, *rest).dtype == torch.bfloat16
        assert len(lib.launches) == 1
        refused = [(qkv.float(), table, 2, 12, 12),                 # f32
                   (qkv, table[:, :1].contiguous(), 1, 12, 12),     # head width 64
                   (qkv[..., :3 * 24], table[:, :1].contiguous(), 1, 12, 12)]   # 24 wide
        for q, t, heads, ws, tws in refused:
            with pytest.raises(ValueError, match="kernel takes bf16"):
                window_attention(q, t, heads, ws, tws, *rest[3:])
        big = inputs(14, 14, 0, (1, 1), 1)                          # window over 12
        with pytest.raises(ValueError, match="kernel takes bf16"):
            window_attention(*big)
    with pytest.raises(ValueError, match="no backward"):            # a gradient asked for
        window_attention(qkv, table.requires_grad_(), *rest)
    assert len(lib.launches) == 1
    # the twin stays reachable on a card by asking for it
    with torch.no_grad():
        assert torch.equal(window_attention(qkv, table, *rest, impl="twin"),
                           window_attention_twin(qkv, table, *rest))


SWINL_SMALL = dict(embed_dim=32, depths=(2, 2, 18, 2), num_heads=(1, 2, 4, 8), window_size=12)


@pytest.mark.parametrize("mode,attention,calls", [("eval", "kernel", 24),
                                                   ("train", "kernel", 0),
                                                   ("eval", "twin", 0)])
def test_every_swinl_block_calls_k6_in_the_bf16_eval_forward(monkeypatch, mode, attention,
                                                             calls):
    """Swin-L's 24 blocks at width 32 per head: K6 (through
    ``graphs.hand_kernel``'s attribute) in every block of an eval-mode
    forward, whether or not a gradient is enabled (on a card the wrapper
    then raises); the twin in train mode and in a backbone built with
    ``attention="twin"``."""
    model = swin.SwinTransformer(**SWINL_SMALL, attention=attention).train(mode == "train")
    seen = []

    def counted(*args, **kwargs):
        seen.append(args[3])
        return window_attention(*args, **kwargs)
    monkeypatch.setattr(swin, "window_attention", counted)
    x = torch.rand(1, 3, 112, 104)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        model(x)
    assert len(seen) == calls
    if calls:          # 28x26 and 14x13 maps at window 12; 7x7 and 4x4 clamped
        assert seen == [12] * 4 + [7] * 18 + [4] * 2


@pytest.mark.parametrize("dtype,attention", [("bfloat16", "kernel"), ("float32", "twin")])
def test_the_configurations_dtype_chooses_the_backbones_attention(dtype, attention):
    """K6 computes in bf16 only, so the model builds an f32 configuration's
    Swin backbone with the twin, by construction and visibly."""
    import dataclasses

    config = dataclasses.replace(CVPPP_RECIPE, backbone_name="D2SwinTransformer",
                                 swin_embed_dim=32, swin_depths=(1, 1, 1, 1),
                                 swin_num_heads=(1, 2, 4, 8), dtype=dtype)
    backbone = PCTransModel(config).backbone
    assert backbone.attention == attention
    assert {m.kernel for m in backbone.modules()
            if isinstance(m, swin.WindowAttention)} == {attention == "kernel"}


def test_a_backbone_refuses_an_unknown_attention():
    with pytest.raises(ValueError, match="attention"):
        swin.SwinTransformer(**SWINL_SMALL, attention="auto")


PUBLISHED_SWINL = {"EMBED_DIM": 192, "DEPTHS": [2, 2, 18, 2], "NUM_HEADS": [6, 12, 24, 48],
                   "WINDOW_SIZE": 12, "APE": False, "DROP_PATH_RATE": 0.3,
                   "PATCH_NORM": True, "PRETRAIN_IMG_SIZE": 384}


def test_mask2formers_published_swinl_node_maps_to_the_model():
    cfg = get_cfg_defaults()
    cfg.MODEL.BACKBONE.NAME = "D2SwinTransformer"
    cfg.MODEL.SWIN = CfgNode(dict(PUBLISHED_SWINL, PATCH_SIZE=4, MLP_RATIO=4.0, QKV_BIAS=True,
                                  QK_SCALE=None, DROP_RATE=0.0, ATTN_DROP_RATE=0.0,
                                  USE_CHECKPOINT=False,
                                  OUT_FEATURES=["res2", "res3", "res4", "res5"]))
    c = build_model_config(cfg)
    assert (c.swin_embed_dim, c.swin_depths, c.swin_num_heads, c.swin_window_size,
            c.swin_drop_path) == (192, (2, 2, 18, 2), (6, 12, 24, 48), 12, 0.3)


UNHONOURED = [("APE", True), ("PATCH_NORM", False), ("PATCH_SIZE", 2), ("MLP_RATIO", 3.0),
              ("QKV_BIAS", False), ("QK_SCALE", 0.125), ("DROP_RATE", 0.1),
              ("ATTN_DROP_RATE", 0.1), ("USE_CHECKPOINT", True),
              ("OUT_FEATURES", ["res3", "res4", "res5"]), ("MLP_RATIO", True),
              ("FROZEN_STAGES", 1)]


@pytest.mark.parametrize("key,value", UNHONOURED)
def test_swin_node_refuses_what_the_port_cannot_honour(key, value):
    with pytest.raises(ValueError, match=f"MODEL.SWIN.{key}"):
        swin_fields(CfgNode(dict(PUBLISHED_SWINL, **{key: value})))


def test_every_fixed_key_is_refused_by_some_case():
    assert {k for k, _ in UNHONOURED} >= set(SWIN_FIXED)
    assert math.isclose(SWIN_FIXED["MLP_RATIO"], 4.0)
