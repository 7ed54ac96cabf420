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
