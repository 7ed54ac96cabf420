"""Gradients of the port's ms-deform twin (the plain version of K2) against
``jax.grad`` through ``ms_deform_attn_core_pallas2``: its custom VJP runs
the Pallas backward ``_level_bwd_kernel`` in interpret mode, as
``tests/test_ops.py`` runs it on the CPU.

Tolerance: f32 on both sides, different summation orders; rtol/atol 1e-4
as ``tests/test_ops.py``'s own Pallas-backward check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.ops.msdeform import ms_deform_attn_core_reference
from pctrans_tpu.ops.msdeform_pallas2 import ms_deform_attn_core_pallas2
from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_backward,
                                        ms_deform_attn_twin)

torch.set_num_threads(1)

SHAPES = ((6, 5), (3, 4))             # 2 levels, odd sizes
RTOL = ATOL = 1e-4


def _inputs(seed, B=2, Lq=150, M=2, D=16, P=3, on_grid=False):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in SHAPES)
    L = len(SHAPES)
    value = rng.randn(B, S, M, D).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32)
    if on_grid:
        # exactly integral pixel coordinates: loc * size - 0.5 = k; sizes
        # and the +0.5 make loc = (k + 0.5) / size exact in f32 only up to
        # rounding, so check the pixel coordinate itself below
        for lid, (H, W) in enumerate(SHAPES):
            k = rng.randint(-1, max(H, W) + 1, (B, Lq, M, P, 2))
            size = np.array([W, H], np.float32)
            locs[:, :, :, lid] = ((k + 0.5) / size).astype(np.float32)
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    g = rng.randn(B, Lq, M * D).astype(np.float32)
    return value, locs, attn, g


def _jax_grads(fn, value, locs, attn, g):
    def loss(v, l, a):
        return (fn(v, SHAPES, l, a) * g).sum()

    return [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attn))]


def _torch_grads(value, locs, attn, g):
    prim = [torch.from_numpy(a).requires_grad_() for a in (value, locs, attn)]
    out = ms_deform_attn(prim[0], list(SHAPES), prim[1], prim[2])
    (out * torch.from_numpy(g)).sum().backward()
    return [p.grad.numpy() for p in prim]


def _pallas2(v, shapes, l, a):
    return ms_deform_attn_core_pallas2(v, shapes, l, a, chunk=128)


def test_twin_grads_match_pallas_backward_off_grid():
    args = _inputs(0)
    ref = _jax_grads(_pallas2, *args)
    ours = _torch_grads(*args)
    for name, a, b in zip(("value", "locations", "weights"), ours, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_twin_grads_match_pallas_backward_on_integral_points():
    """At an exactly integral pixel coordinate the hat derivative is 0
    along that axis.  The twin agrees with the Pallas backward there; the
    4-corner reference (grid_sample's convention) does not."""
    value, locs, attn, g = _inputs(1, Lq=40, on_grid=True)
    for lid, (H, W) in enumerate(SHAPES):
        px = locs[:, :, :, lid, :, 0] * W - np.float32(0.5)
        assert (px == np.round(px)).mean() > 0.9
    ref = _jax_grads(_pallas2, value, locs, attn, g)
    ours = _torch_grads(value, locs, attn, g)
    for name, a, b in zip(("value", "locations", "weights"), ours, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    floor_rule = _jax_grads(ms_deform_attn_core_reference, value, locs, attn, g)
    assert not np.allclose(floor_rule[1], ref[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(floor_rule[2], ref[2], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_wrapper_takes_the_twin_on_cpu(dtype):
    value, locs, attn, g = _inputs(2, Lq=17)
    v = torch.from_numpy(value).to(dtype)
    l, a = torch.from_numpy(locs), torch.from_numpy(attn)
    gt = torch.from_numpy(g).to(dtype)
    before = ms_deform_attn_backward.launches
    dv, dl, dw = ms_deform_attn_backward(v, list(SHAPES), l, a, gt)
    assert ms_deform_attn_backward.launches == before     # no kernel launched
    assert (dv.dtype, dl.dtype, dw.dtype) == (dtype, torch.float32, torch.float32)
    prim = [t.clone().requires_grad_() for t in (v, l, a)]
    out = ms_deform_attn_twin(prim[0], list(SHAPES), prim[1], prim[2])
    ref = torch.autograd.grad(out, prim, gt)
    for x, y in zip((dv, dl, dw), ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _k2_emulation(value, shapes, loc, w, grad):
    """K2's per-sample arithmetic (``pctrans_torch/csrc/msdeform_bwd.cu``)
    vectorised in f32 on the CPU: corner indices clamped as the kernel
    clamps them (``fmaxf`` maps NaN to -1), validity flags from float
    compares, the reach test and the hat-derivative tests as selects, d_loc
    scaled by the level size, one f32 add of ``a * corner weight * grad``
    per valid corner into d_value."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    v = value.float()
    g = grad.float().reshape(B, Lq, M, 1, D)
    dv = torch.zeros(B, S, M, D)
    dl = torch.zeros(loc.shape)
    dw = torch.zeros(w.shape)
    bi = torch.arange(B).view(B, 1, 1, 1).expand(B, Lq, M, P)
    mi = torch.arange(M).view(1, 1, M, 1).expand(B, Lq, M, P)
    start = 0
    for lid, (H, W) in enumerate(shapes):
        Wf, Hf = torch.tensor(float(W)), torch.tensor(float(H))
        x = loc[:, :, :, lid, :, 0] * Wf - 0.5
        y = loc[:, :, :, lid, :, 1] * Hf - 0.5
        a = w[:, :, :, lid]
        x0f, y0f = torch.floor(x), torch.floor(y)
        tx, ty = x - x0f, y - y0f
        inside = (x > -1) & (x < Wf) & (y > -1) & (y < Hf)
        vx0, vx1 = x0f >= 0, x0f < Wf - 1
        vy0, vy1 = y0f >= 0, y0f < Hf - 1
        ix = torch.fmin(torch.fmax(x0f, torch.tensor(-1.0)), Wf).long()
        iy = torch.fmin(torch.fmax(y0f, torch.tensor(-1.0)), Hf).long()
        cx0, cx1 = ix.clamp(0, W - 1), (ix + 1).clamp(max=W - 1)
        cy0, cy1 = iy.clamp(0, H - 1), (iy + 1).clamp(max=H - 1)
        ok = [inside & vy0 & vx0, inside & vy0 & vx1, inside & vy1 & vx0, inside & vy1 & vx1]
        pos = [cy0 * W + cx0, cy0 * W + cx1, cy1 * W + cx0, cy1 * W + cx1]
        vl = v[:, start:start + H * W]
        c = [torch.where(k[..., None], vl[bi, p, mi], 0.0) for k, p in zip(ok, pos)]
        wx0, wx1, wy0, wy1 = (t[..., None] for t in (1 - tx, tx, 1 - ty, ty))
        smp = wy0 * (wx0 * c[0] + wx1 * c[1]) + wy1 * (wx0 * c[2] + wx1 * c[3])
        dot = (g * smp).sum(-1)
        sx = (g * (wy0 * (c[1] - c[0]) + wy1 * (c[3] - c[2]))).sum(-1)
        sy = (g * (wx0 * (c[2] - c[0]) + wx1 * (c[3] - c[1]))).sum(-1)
        dw[:, :, :, lid] = torch.where(inside, dot, 0.0)
        dl[:, :, :, lid, :, 0] = torch.where(inside & (tx > 0), a * sx, 0.0) * Wf
        dl[:, :, :, lid, :, 1] = torch.where(inside & (ty > 0), a * sy, 0.0) * Hf
        f = [a * wy0[..., 0] * wx0[..., 0], a * wy0[..., 0] * wx1[..., 0],
             a * wy1[..., 0] * wx0[..., 0], a * wy1[..., 0] * wx1[..., 0]]
        for k, p, fk in zip(ok, pos, f):
            add = torch.where(k[..., None], fk[..., None] * g, 0.0)
            dv.index_put_((bi, start + p, mi), add, accumulate=True)
        start += H * W
    return dv, dl, dw


def _rehearsal_inputs(case, seed=5):
    value, locs, attn, g = _inputs(seed, Lq=60, on_grid=case == "integral")
    rng = np.random.RandomState(seed + 1)
    if case == "nan":
        locs[rng.rand(*locs.shape) < 1 / 3] = np.nan
    elif case == "outside":
        locs = np.where(locs < 0.5, locs - 1.5, locs + 1.0).astype(np.float32)
    elif case == "contention":
        # every sample of level 0 of a (batch, head) in one 2x2 block of cells
        H, W = SHAPES[0]
        corner = rng.randint(1, min(H, W) - 2, (2, 1, 2, 1, 2))
        frac = rng.rand(2, 60, 2, 3, 2)
        locs[:, :, :, 0] = ((corner + frac + 0.5) / np.array([W, H])).astype(np.float32)
    return value, locs, attn, g


@pytest.mark.parametrize("case", ["mixed", "integral", "nan", "outside", "contention"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_arithmetic_rehearsal_matches_twin_autograd(case, dtype):
    """The kernel cannot run here; its arithmetic, emulated on the CPU, is
    held to the twin's autograd with K2's card tolerance in f32 (rel-Fro
    1e-5: the same f32 terms summed in another order), on the cases the
    card tests cover: NaN and all-outside samples (zero gradients),
    integral coordinates (hat derivative 0) and every query of a head in
    the same coarse cells."""
    value, locs, attn, g = _rehearsal_inputs(case)
    v = torch.from_numpy(value).to(dtype)
    l, a = torch.from_numpy(locs), torch.from_numpy(attn)
    gt = torch.from_numpy(g).to(dtype)
    ours = _k2_emulation(v, list(SHAPES), l, a, gt)
    prim = [v.float().requires_grad_(), l.clone().requires_grad_(), a.clone().requires_grad_()]
    out = ms_deform_attn_twin(prim[0], list(SHAPES), prim[1], prim[2])
    ref = torch.autograd.grad(out, prim, gt.float())
    for name, x, y in zip(("value", "locations", "weights"), ours, ref):
        assert bool(torch.isfinite(x).all()), name
        if case == "nan" and name != "value":
            # the twin's autograd carries a NaN location into the sample's
            # location and weight gradients; the kernel gives 0 there (the
            # sample contributes nothing)
            nan = torch.isnan(y)
            nan_sample = torch.isnan(l).any(-1)
            if name == "locations":
                nan_sample = nan_sample[..., None].expand_as(l)
            assert bool(nan.any()) and bool(nan_sample[nan].all()) and not x[nan].any()
            x, y = x[~nan], y[~nan]
        if case == "outside":
            assert not x.any() and not y.any(), name
        else:           # "integral": both location gradients are exactly 0
            assert float((x - y).norm()) <= 1e-5 * float(y.norm()), name


@pytest.mark.parametrize("D,dtype,ok", [
    (16, torch.bfloat16, True), (8, torch.float32, True), (4, torch.bfloat16, True),
    (128, torch.float32, True), (12, torch.float32, False), (6, torch.bfloat16, False),
    (256, torch.bfloat16, False)])
def test_backward_layout_rule(D, dtype, ok):
    """K2 takes 4 channels per thread and sums a head's D / 4 threads
    within a warp: D must be 4 times a power of two <= 32 in either dtype."""
    from pctrans_torch.ops.msdeform import _check_backward_layout
    value = torch.zeros(1, 6, 2, D, dtype=dtype)
    loc, w = torch.zeros(1, 5, 2, 1, 2, 2), torch.zeros(1, 5, 2, 1, 2)
    if ok:
        _check_backward_layout(value, loc, w)
    else:
        with pytest.raises(ValueError, match="4 times a power of two"):
            _check_backward_layout(value, loc, w)


def test_backward_layout_rule_refuses_unaligned_value():
    value = torch.zeros(1 + 6 * 2 * 8)[1:].reshape(1, 6, 2, 8)
    loc, w = torch.zeros(1, 5, 2, 1, 2, 2), torch.zeros(1, 5, 2, 1, 2)
    from pctrans_torch.ops.msdeform import _check_backward_layout
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_backward_layout(value, loc, w)


@pytest.mark.parametrize("shapes,Lq,P,mask", [
    (((14, 14), (28, 28), (56, 56)), 4116, 4, 0b001),   # CVPPP train: 84, 21, 5.25
    (((17, 16), (34, 32), (67, 63)), 5581, 4, 0b001),   # CVPPP eval: 82, 20.5, 5.3
    (((56, 56), (28, 28), (14, 14)), 4116, 4, 0b100),   # the order of the levels
    (((6, 5), (3, 4)), 150, 3, 0b10),                   # 15 and 37.5
    (((120, 100), (4, 4), (9, 7)), 301, 4, 0b010),
    (((4, 4),), 127, 4, 0b0),                           # 31.75: just below
    (((4, 4),), 128, 4, 0b1),                           # 32: just at
])
def test_backward_aggregated_levels(shapes, Lq, P, mask):
    """K2 sums a warp's adds per corner before reducing on the levels whose
    queries put at least 32 samples on each position on average."""
    from pctrans_torch.ops.msdeform import backward_aggregated_levels
    assert backward_aggregated_levels(shapes, Lq, P) == mask
