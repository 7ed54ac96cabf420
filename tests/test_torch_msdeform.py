"""ms-deform attention twin of the PyTorch port (pctrans_torch/ops/msdeform.py)
against the JAX package: the Pallas v2 kernel in interpret mode (how the
JAX tests run it on the CPU) and the 4-corner reference.

Tolerance: f32 on both sides; the twin samples with grid_sample, so the
pixel coordinate is rounded through 2*loc - 1 and the sums run in another
order.  Both stay within atol 1e-5 on O(1) values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.ops.msdeform import ms_deform_attn_core_reference
from pctrans_tpu.ops.msdeform_pallas2 import ms_deform_attn_core_pallas2
from pctrans_torch.ops.msdeform import ms_deform_attn, ms_deform_attn_twin

torch.set_num_threads(1)

SHAPES = [(5, 7), (3, 4)]           # 2 levels, odd sizes


def _inputs(seed, B=2, Lq=13, M=2, D=16, P=3):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in SHAPES)
    L = len(SHAPES)
    value = rng.randn(B, S, M, D).astype(np.float32)
    # ~1/3 of the samples fall (partly) outside the maps
    locs = rng.uniform(-0.2, 1.2, (B, Lq, M, L, P, 2)).astype(np.float32)
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    return value, locs, attn


@pytest.mark.parametrize("seed,Lq", [(0, 13), (1, 1), (2, 40)])
def test_twin_matches_jax_pallas2_and_reference(seed, Lq):
    value, locs, attn = _inputs(seed, Lq=Lq)
    jargs = (jnp.asarray(value), tuple(SHAPES), jnp.asarray(locs), jnp.asarray(attn))
    pallas = np.asarray(ms_deform_attn_core_pallas2(*jargs))
    ref = np.asarray(ms_deform_attn_core_reference(*jargs))
    ours = ms_deform_attn_twin(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(locs), torch.from_numpy(attn))
    assert ours.shape == (2, Lq, 2 * 16) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_wrapper_takes_the_twin_on_cpu():
    value, locs, attn = _inputs(3)
    args = (torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
            torch.from_numpy(attn))
    before = ms_deform_attn.launches
    out = ms_deform_attn(*args)
    assert ms_deform_attn.launches == before          # no kernel launched
    torch.testing.assert_close(out, ms_deform_attn_twin(*args), rtol=0, atol=0)


def test_twin_keeps_the_value_dtype():
    value, locs, attn = _inputs(4)
    out = ms_deform_attn_twin(torch.from_numpy(value).bfloat16(), SHAPES,
                              torch.from_numpy(locs), torch.from_numpy(attn))
    assert out.dtype == torch.bfloat16


def test_wrapper_rejects_mismatched_shapes():
    value, locs, attn = _inputs(5)
    with pytest.raises(ValueError):
        ms_deform_attn(torch.from_numpy(value), [(5, 7)],
                       torch.from_numpy(locs), torch.from_numpy(attn))
