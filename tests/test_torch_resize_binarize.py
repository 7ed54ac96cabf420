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


K4_COLS = 4        # output columns per K4 thread (resize_binarize.cu)


def _k4_tile_rows(row_idx, i0, i1):
    """The source rows one K4 thread W-interpolates over output rows
    [i0, i1), in order, and per output row the (r0, r1) it uses: the
    kernel keeps the last two interpolated rows and computes a tap only
    when neither holds it."""
    ia = ib = -1
    computed, taps = [], []
    for i in range(i0, i1):
        r0, r1 = (int(r) for r in row_idx[i])
        if r0 != ia and r0 != ib:
            computed.append(r0)
        if r1 != r0 and r1 != ib:
            computed.append(r1)
        taps.append((r0, r1))
        ia, ib = r0, r1
    return computed, taps


def _k4_emulation(x, size, logit_t, rows_per_tile):
    """K4's thread loop in numpy f32: per image, tile of rows and group of
    K4_COLS columns, the cached W-interpolated rows, and the packing of
    (v > t) into little-endian 32-bit words (byte c for column c), stored
    byte by byte up to the image's edge."""
    N, h, w = x.shape
    H, W = size
    ridx, rwt = interp_table(h, H)
    cidx, cwt = interp_table(w, W)
    t32 = np.float32(logit_t)
    out = np.full((N, H, W), 7, np.uint8)
    for n in range(N):
        for i0 in range(0, H, rows_per_tile):
            i1 = min(i0 + rows_per_tile, H)
            for j0 in range(0, W, K4_COLS):
                cols = np.minimum(np.arange(j0, j0 + K4_COLS), W - 1)
                c0, c1 = cidx[cols, 0], cidx[cols, 1]
                w0, w1 = cwt[cols, 0], cwt[cols, 1]
                held = {}
                for i in range(i0, i1):
                    r0, r1 = (int(r) for r in ridx[i])
                    row = {r: held[r] if r in held else w0 * x[n, r, c0] + w1 * x[n, r, c1]
                           for r in (r0, r1)}
                    held = row
                    v = rwt[i, 0] * row[r0] + rwt[i, 1] * row[r1]
                    words = np.zeros(K4_COLS // 4, np.uint32)
                    for c in range(K4_COLS):
                        words[c // 4] |= np.uint32(v[c] > t32) << np.uint32(8 * (c % 4))
                    nbytes = min(K4_COLS, W - j0)
                    out[n, i, j0:j0 + nbytes] = words.view(np.uint8)[:nbytes]
    return out


@pytest.mark.parametrize("shape,size,rows", [
    ((2, 3, 17, 21), (68, 84), 16),
    ((1, 4, 13, 16), (50, 61), 32),     # W not a multiple of 4
    ((1, 4, 13, 16), (50, 61), 5),      # ragged tiles
    ((2, 2, 40, 30), (13, 11), 16),     # downsample
    ((1, 2, 7, 9), (1, 20), 16),        # H = 1
])
def test_k4_thread_rehearsal_matches_twin(shape, size, rows):
    """The kernel cannot run here; its per-thread loop (row cache, tails,
    byte packing), emulated on the CPU, agrees with the twin except where
    the f32 logit is within 1e-5 of the threshold (another rounding of the
    same interpolation)."""
    x = np.random.RandomState(3).randn(*shape).astype(np.float32) * 2.0
    ours = _k4_emulation(x.reshape(-1, *shape[2:]), size, LOGIT_T, rows)
    ours = ours.reshape(shape[:2] + size)
    twin = resize_binarize_twin(torch.from_numpy(x), size, LOGIT_T).numpy()
    assert ours.max() <= 1 and ours.any() and (ours == 0).any()
    logits = resize_bilinear(torch.from_numpy(x), size).numpy()
    differ = ours != twin
    assert (np.abs(logits[differ] - LOGIT_T) <= 1e-5).all()


@pytest.mark.parametrize("in_size,out_size", [(133, 530), (125, 500), (40, 13),
                                              (13, 50), (7, 1)])
@pytest.mark.parametrize("rows_per_tile", [1, 5, 16, 32, 64])
def test_k4_tile_interpolates_each_window_row_once(in_size, out_size, rows_per_tile):
    """Every tap of every output row of a tile lies in the tile's source
    window [row_idx[i0, 0], row_idx[i1 - 1, 1]] (the taps are non-decreasing
    in the output row), and a K4 thread W-interpolates each window row at
    most once; when upsampling, exactly once."""
    ridx, _ = interp_table(in_size, out_size)
    assert (np.diff(ridx[:, 0]) >= 0).all() and (ridx[:, 1] >= ridx[:, 0]).all()
    for i0 in range(0, out_size, rows_per_tile):
        i1 = min(i0 + rows_per_tile, out_size)
        lo, hi = ridx[i0, 0], ridx[i1 - 1, 1]
        computed, taps = _k4_tile_rows(ridx, i0, i1)
        assert all(lo <= r <= hi for tap in taps for r in tap)
        assert len(computed) == len(set(computed)) and set(computed) <= set(range(lo, hi + 1))
        assert set(computed) == {r for tap in taps for r in tap}
        if out_size >= in_size:
            assert sorted(computed) == list(range(lo, hi + 1))
