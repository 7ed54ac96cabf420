"""Resize and fused upsample+binarize of the PyTorch port against the JAX
package (pctrans_tpu/ops/resize.py, pctrans_tpu/ops/resize_pallas.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.ops.resize import resize_bilinear as jax_resize
from pctrans_tpu.ops.resize_pallas import _pallas_resize_binarize, resize_weights
from pctrans_torch.ops.resize import resize_bilinear
from pctrans_torch.ops.resize_binarize import (interp_table,
                                               resize_bilinear_binarize,
                                               resize_binarize_twin)

torch.set_num_threads(1)

LOGIT_T = math.log(0.69 / 0.31)


@pytest.mark.parametrize("shape,size", [
    ((2, 3, 67, 63), (133, 125)),   # FPN upsample res3' -> res2 grid
    ((2, 3, 33, 31), (66, 62)),     # clean 2x upsample
    ((2, 5, 133, 125), (67, 63)),   # attention-mask downsample to res3
    ((2, 5, 133, 125), (17, 16)),   # attention-mask downsample to res5
    ((1, 2, 16, 16), (4, 4)),       # integer ratio downsample
])
def test_resize_bilinear_matches_jax_image_resize(shape, size):
    """jax.image.resize(antialias=False) == F.interpolate(align_corners=
    False) in both directions.  Tolerance atol 1e-4: the two compute the
    sample coordinate (up to ~130 px) with different f32 roundings, ~1e-5 px,
    times slopes of up to ~4 per px in N(0, 1) data."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), size))
    ours = resize_bilinear(torch.from_numpy(x), size).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("in_size,out_size", [(133, 530), (125, 500),
                                              (13, 50), (16, 61), (50, 13)])
def test_interp_table_is_resize_weights(in_size, out_size):
    """The K4 tables, made dense, are the JAX kernel's interpolation
    matrix (jax.image.resize of an identity).  Tolerance atol 2e-5: JAX
    computes the sample coordinates in f32 (half an ulp at 133 px is
    7.6e-6 px), the tables in f64 rounded once to f32."""
    idx, w = interp_table(in_size, out_size)
    dense = np.zeros((out_size, in_size), np.float64)
    np.add.at(dense, (np.arange(out_size)[:, None], idx), w)
    ref = np.asarray(resize_weights(in_size, out_size))
    np.testing.assert_allclose(dense, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,size", [
    ((2, 3, 17, 21), (68, 84)),     # clean 4x
    ((1, 4, 13, 16), (50, 61)),     # non-integer scale, odd sizes
])
def test_twin_matches_jax_paths(shape, size):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 2.0
    ref_f32 = np.asarray(jax_resize(jnp.asarray(x), size))
    ours = resize_binarize_twin(torch.from_numpy(x), size, LOGIT_T).numpy()
    assert ours.dtype == np.uint8 and ours.shape == shape[:2] + size
    assert ours.any() and (ours == 0).any()
    # against the f32 plain path: exact but within f32 rounding (1e-5) of
    # the threshold
    plain = (ref_f32 > LOGIT_T).astype(np.uint8)
    differ = ours != plain
    assert (np.abs(ref_f32[differ] - LOGIT_T) <= 1e-5).all()
    # against the Pallas kernel (interpret mode): its dots take bf16
    # operands, so it may differ where the logit is within bf16 noise of
    # the threshold -- the JAX package's own bound, tests/test_resize_pallas.py
    pallas = np.asarray(_pallas_resize_binarize(jnp.asarray(x), size, LOGIT_T,
                                                interpret=True))
    margin = 2e-2 * (np.abs(ref_f32) + 1.0)
    differ = ours != pallas
    assert (np.abs(ref_f32[differ] - LOGIT_T) <= margin[differ]).all()


def test_wrapper_takes_the_twin_on_cpu():
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 3, 9, 11).astype(np.float32))
    before = resize_bilinear_binarize.launches
    out = resize_bilinear_binarize(x, (36, 44), LOGIT_T)
    assert resize_bilinear_binarize.launches == before
    torch.testing.assert_close(out, resize_binarize_twin(x, (36, 44), LOGIT_T),
                               rtol=0, atol=0)
