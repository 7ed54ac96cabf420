"""Dynamic mask render twin of the PyTorch port (pctrans_torch/ops/render.py)
against the JAX package: the Pallas render kernel in interpret mode and the
einsum ``render_reference`` in f32.

Tolerance: atol 1e-4.  Both sides run f32, but the Pallas kernel folds the
rel-coord term into one dot over [feats, -px, -py, 1] with the instance
position added to the bias, so pixel coordinates up to ~50 are cancelled
in another order; outputs are O(10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.ops.render_pallas import dynamic_mask_render as jax_render
from pctrans_tpu.ops.render_pallas import render_reference
from pctrans_torch.ops.render import dynamic_mask_render, render_twin

torch.set_num_threads(1)

HW = (6, 7)
STRIDE = 4


def _inputs(seed, rel_coord, B=2, Q=5, Cm=8, ch=8):
    rng = np.random.RandomState(seed)
    cin = Cm + (2 if rel_coord else 0)
    Hm, Wm = HW
    feats = rng.randn(B, Hm * Wm, Cm).astype(np.float32)
    inst_xy = (rng.rand(B, Q, 2) * [Wm * STRIDE, Hm * STRIDE]).astype(np.float32)
    w1 = (rng.randn(B, Q, ch, cin) * 0.3).astype(np.float32)
    if rel_coord:
        w1[..., :2] *= 0.05                   # rel coords are in pixels
    w2 = (rng.randn(B, Q, ch, ch) * 0.3).astype(np.float32)
    w3 = (rng.randn(B, Q, 1, ch) * 0.3).astype(np.float32)
    b1 = rng.randn(B, Q, ch).astype(np.float32)
    b2 = rng.randn(B, Q, ch).astype(np.float32)
    b3 = rng.randn(B, Q, 1).astype(np.float32)
    return feats, inst_xy, w1, w2, w3, b1, b2, b3


@pytest.mark.parametrize("rel_coord", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_jax_kernel_and_reference(seed, rel_coord):
    args = _inputs(seed, rel_coord)
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jax_render(*jargs, HW, STRIDE, rel_coord))
    ref = np.asarray(render_reference(*jargs, hw=HW, stride=STRIDE,
                                      rel_coord=rel_coord, dtype=jnp.float32))
    ours = render_twin(*[torch.from_numpy(a) for a in args], HW, STRIDE, rel_coord)
    assert ours.shape == (2, 5, HW[0] * HW[1]) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), pallas, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


def test_wrapper_takes_the_twin_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(2, True)]
    before = dynamic_mask_render.launches
    out = dynamic_mask_render(*args, HW, STRIDE, True)
    assert dynamic_mask_render.launches == before
    torch.testing.assert_close(out, render_twin(*args, HW, STRIDE, True),
                               rtol=0, atol=0)


def test_wrapper_rejects_inconsistent_shapes():
    args = [torch.from_numpy(a) for a in _inputs(3, True)]
    with pytest.raises(ValueError):
        dynamic_mask_render(*args, HW, STRIDE, False)   # w1 has rel rows


# --------------------------------------------------- bf16: the train graph
def _bf16_inputs(seed, rel_coord, B=2, Q=6, hw=(12, 10), Cm=16, ch=8):
    """Numpy inputs rounded to bf16 (inst_xy stays f32, as in the decoder)."""
    rng = np.random.RandomState(seed)
    Hm, Wm = hw
    cin = Cm + (2 if rel_coord else 0)
    w1 = rng.randn(B, Q, ch, cin) * 0.3
    if rel_coord:
        w1[..., :2] *= 0.05
    arrays = [rng.randn(B, Hm * Wm, Cm),
              rng.rand(B, Q, 2) * [Wm * STRIDE, Hm * STRIDE], w1,
              rng.randn(B, Q, ch, ch) * 0.3, rng.randn(B, Q, 1, ch) * 0.3,
              rng.randn(B, Q, ch), rng.randn(B, Q, ch), rng.randn(B, Q, 1)]
    return [torch.from_numpy(a.astype(np.float32)).to(
        torch.float32 if i == 1 else torch.bfloat16) for i, a in enumerate(arrays)]


@pytest.mark.parametrize("rel_coord", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_twin_bf16_is_bit_equal_to_jax_reference(seed, rel_coord):
    """The train graph's render: ``render_reference(dtype=bf16)`` rounds the
    feature product, stage 1's sum and stages 2 and 3 to bf16 and keeps the
    rel term in f32; ``render_twin(dtype=bf16)`` casts at the same points,
    so the two agree bit for bit (the f32 render does not)."""
    hw = (12, 10)
    args = _bf16_inputs(seed, rel_coord, hw=hw)
    jargs = [jnp.asarray(a.float().numpy()).astype(a.dtype == torch.bfloat16
                                                   and jnp.bfloat16 or jnp.float32)
             for a in args]
    ref = np.asarray(render_reference(*jargs, hw=hw, stride=STRIDE,
                                      rel_coord=rel_coord, dtype=jnp.bfloat16))
    ours = render_twin(*args, hw, STRIDE, rel_coord, dtype=torch.bfloat16)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_decoder_train_mode_renders_in_the_compute_dtype(monkeypatch):
    """Train mode under bf16 autocast renders every layer's masks through
    ``render_twin(dtype=bf16)`` (the JAX train graph's einsums in the compute
    dtype), and eval mode through the K3 wrapper."""
    from pctrans_torch.models import transformer_decoder as td

    calls = []
    twin = td.render_twin

    def spy(*args, **kwargs):
        out = twin(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(td, "render_twin", spy)
    torch.manual_seed(0)
    dec = td.MultiScaleMaskedTransformerDecoder(
        32, hidden_dim=32, num_queries=6, nheads=4, dim_feedforward=64,
        dec_layers=2, mask_dim=8, sem_loss_on=False).train()
    with torch.no_grad():
        for p in dec.parameters():         # query_feat etc. start uninitialised
            p.normal_(0.0, 0.2)
    x = [torch.randn(2, 32, s, s) for s in (2, 4, 8)]
    mask_features = torch.randn(2, 32, 16, 16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = dec(x, mask_features)
    assert len(calls) == 3
    for args, kwargs, logits in calls:
        assert kwargs == {"dtype": torch.bfloat16}
        assert args[0].dtype == torch.bfloat16               # mask features
        torch.testing.assert_close(logits, twin(*args, dtype=torch.bfloat16),
                                   rtol=0, atol=0)
    assert out["pred_masks"].dtype == torch.bfloat16
    torch.testing.assert_close(out["pred_masks"],
                               calls[-1][2].reshape(2, 6, 16, 16).to(torch.bfloat16),
                               rtol=0, atol=0)

    calls.clear()
    before = dynamic_mask_render.launches
    with torch.autocast("cpu", dtype=torch.bfloat16), torch.no_grad():
        dec.eval()(x, mask_features)
    assert calls == [] and dynamic_mask_render.launches == before   # CPU: K3's twin


# ------------------------------------- K3's arithmetic, rehearsed on the CPU
# A test-only emulation of render.cu's warp: the mma.sync m16n8k8 TF32
# fragment layouts, the 3xTF32 split (cvt.rna.tf32.f32: round to nearest,
# ties away from zero, at 10 mantissa bits; in the hot loop's stage-2 split
# the same rounding of hi in integer ops and lo = x - hi passed whole, which
# the tensor core truncates to TF32), W1's output channels staged in the
# order PERM so that stage 1's accumulator is stage 2's A fragment, and the
# quad reduction that leaves lane (g, t) with pixels 32 j + 8 t + g of its
# warp's TILES m16 row tiles.  It sizes the
# card gate (rel-Fro <= 1e-5 against the f32 twin) before a chip call.  The
# tensor core's accumulation order inside one mma is not emulated: each
# product sums in f64 and rounds to f32 once.
PERM = (0, 4, 1, 5, 2, 6, 3, 7)
TILES = 4                                   # render.cu kTiles
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def _tf32(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _split_fast(x):
    hi = _tf32(x)
    lo = np.ascontiguousarray(x - hi, np.float32).view(np.uint32)
    return hi, (lo & np.uint32(0xFFFFE000)).view(np.float32)


# register i of lane (g, t) -> (row, column) of the 16x8 A, 8x8 B, 16x8 C tiles
A_RC = [(G + 8 * (i & 1), T + 4 * (i >> 1)) for i in range(4)]
B_RC = [(T + 4 * i, G) for i in range(2)]
C_RC = [(G + 8 * (i >> 1), 2 * T + (i & 1)) for i in range(4)]


def _to_regs(mat, rc):
    return np.stack([mat[..., r, c] for r, c in rc], -1)          # [..., 32, n]


def _from_regs(regs, rc, shape):
    mat = np.zeros(regs.shape[:-2] + shape, regs.dtype)
    for i, (r, c) in enumerate(rc):
        mat[..., r, c] = regs[..., i]
    return mat


def _mma(c_regs, a_regs, b_regs):
    """One mma.sync on fragments: D = A B + C, the product in f64."""
    a = _from_regs(a_regs, A_RC, (16, 8)).astype(np.float64)
    b = _from_regs(b_regs, B_RC, (8, 8)).astype(np.float64)
    d = _from_regs(c_regs, C_RC, (16, 8)) + a @ b
    return _to_regs(d.astype(np.float32), C_RC)


def _mma3(c, a, b):
    (ahi, alo), (bhi, blo) = a, b
    return _mma(_mma(_mma(c, alo, bhi), ahi, blo), ahi, bhi)


def _emulated_render(feats, inst_xy, w1, w2, w3, b1, b2, b3, hw, stride, rel,
                     split=_split, split_act=_split_fast):
    """render.cu's arithmetic, warp by warp: 16 * TILES pixels as m16 tiles."""
    B, HW, Cm = feats.shape
    Q = w1.shape[1]
    ks = -(-Cm // 8)
    off = 2 if rel else 0
    n_warps = -(-HW // (16 * TILES))
    n_tiles = TILES * n_warps
    fpad = np.zeros((B, n_tiles * 16, 8 * ks), np.float32)
    fpad[:, :HW, :Cm] = feats
    fpad = fpad.reshape(B, 1, n_tiles, 16, ks, 8).transpose(0, 1, 2, 4, 3, 5)
    a_feat = split(_to_regs(fpad, A_RC))              # [B, 1, tiles, ks, 32, 4]
    w1f = np.zeros((B, Q, 8, 8 * ks), np.float32)
    w1f[..., :Cm] = w1[..., off:]
    # stage-1 B[k][n] = W1f[PERM[n]][k], one 8x8 block per k-step
    b1mat = w1f[:, :, list(PERM)].reshape(B, Q, 8, ks, 8).transpose(0, 1, 3, 4, 2)
    b_st1 = [x[:, :, None] for x in split(_to_regs(b1mat, B_RC))]
    # accumulator start: b1 + W1_xy . inst_xy - W1_x px - W1_y py, per column
    n = np.arange(n_tiles * 16)
    px = ((n % hw[1]) * stride + stride // 2).astype(np.float32)
    py = ((n // hw[1]) * stride + stride // 2).astype(np.float32)
    wx = w1[..., 0] if rel else np.zeros_like(b1)
    wy = w1[..., 1] if rel else np.zeros_like(b1)
    const = (wx * inst_xy[..., :1] + wy * inst_xy[..., 1:] + b1).astype(np.float32)
    init = (const[:, :, None, :] - wx[:, :, None, :] * px[:, None]
            - wy[:, :, None, :] * py[:, None]).astype(np.float32)   # [B,Q,HWp,8]
    d = _to_regs(init[..., list(PERM)].reshape(B, Q, n_tiles, 16, 8), C_RC)
    for s in range(ks):
        d = _mma3(d, [x[:, :, :, s] for x in a_feat], [x[:, :, :, s] for x in b_st1])
    # stage 2: the accumulator registers (c0, c2, c1, c3) are the A fragment
    a_st2 = split_act(np.maximum(d, 0)[..., [0, 2, 1, 3]])
    b_st2 = [x[:, :, None] for x in split(_to_regs(w2.transpose(0, 1, 3, 2), B_RC))]
    e = _mma3(b2[:, :, None, 2 * T[:, None] + np.array([0, 1, 0, 1])],
              a_st2, b_st2)
    # stage 3: a dot over the lane's columns 2t, 2t + 1 for rows g and g + 8
    w3a = w3[:, :, 0, 2 * T][:, :, None]
    w3b = w3[:, :, 0, 2 * T + 1][:, :, None]
    e = np.maximum(e, 0)
    part = np.stack([w3b * e[..., 1] + w3a * e[..., 0],
                     w3b * e[..., 3] + w3a * e[..., 2]], -1)     # [B,Q,tiles,32,2]
    # res[r], r = 2 * tile + h (pixel 8 r + g), per warp; the quad reduction
    res = part.reshape(B, Q, n_warps, TILES, 32, 2).transpose(0, 1, 2, 4, 3, 5)
    res = res.reshape(B, Q, n_warps, 32, 2 * TILES)
    o1, o2 = (T & 1).astype(bool), (T & 2).astype(bool)
    a = [np.where(o1, res[..., 2 * i + 1], res[..., 2 * i])
         + np.where(o1, res[..., 2 * i], res[..., 2 * i + 1])[..., LANE ^ 1]
         for i in range(TILES)]                            # row 2 i + o1
    out = np.zeros((B, Q, n_warps, 16 * TILES), np.float32)
    for j in range(TILES // 2):                            # row 4 j + t
        out[..., 32 * j + 8 * T + G] = (
            np.where(o2, a[2 * j + 1], a[2 * j])
            + np.where(o2, a[2 * j], a[2 * j + 1])[..., LANE ^ 2])
    return out.reshape(B, Q, -1)[..., :HW] + b3


@pytest.mark.parametrize("Cm,rel_coord", [(16, True), (8, True), (4, False)])
def test_k3_arithmetic_rehearsal_meets_the_card_gate(Cm, rel_coord):
    """The kernel's 3xTF32 arithmetic and fragment mapping, emulated, agree
    with the f32 twin within the card gate's rel-Fro 1e-5, at the gate's
    input distribution (chip_smoke.py ``gate_render``: weights N(0, 0.1),
    rel rows 100x smaller, instance centres over the image)."""
    rng = np.random.RandomState(7)
    B, Q, hw, ch = 2, 5, (13, 9), 8
    cin = Cm + (2 if rel_coord else 0)
    feats = rng.randn(B, hw[0] * hw[1], Cm).astype(np.float32)
    inst_xy = (rng.rand(B, Q, 2) * [hw[1] * 4.0, hw[0] * 4.0]).astype(np.float32)
    w1 = (rng.randn(B, Q, ch, cin) * 0.1).astype(np.float32)
    if rel_coord:
        w1[..., :2] *= 0.01
    w2 = (rng.randn(B, Q, ch, ch) * 0.3).astype(np.float32)
    w3 = (rng.randn(B, Q, 1, ch) * 0.3).astype(np.float32)
    b1, b2 = (rng.randn(B, Q, ch).astype(np.float32) for _ in range(2))
    b3 = rng.randn(B, Q, 1).astype(np.float32)
    args = (feats, inst_xy, w1, w2, w3, b1, b2, b3)
    emulated = _emulated_render(*args, hw, 4, rel_coord)
    twin = render_twin(*[torch.from_numpy(a) for a in args], hw, 4, rel_coord)
    twin = twin.double().numpy()
    err = np.linalg.norm(emulated - twin) / np.linalg.norm(twin)
    assert err <= 1e-5, err
    # one TF32 product per term misses the gate: the split is what keeps it
    single = lambda x: (_tf32(x), np.zeros_like(x))
    one = _emulated_render(*args, hw, 4, rel_coord, split=single, split_act=single)
    assert np.linalg.norm(one - twin) / np.linalg.norm(twin) > 1e-5
