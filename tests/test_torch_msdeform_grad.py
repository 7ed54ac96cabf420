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
