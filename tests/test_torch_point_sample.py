"""The port's point samplers against the JAX package's
(``pctrans_tpu/ops/point_sample.py``) on the same numpy inputs and on the
uniform draws JAX makes from its own keys.

``grid_sample_bilinear``: in f32 both sides sum the same four products in
another order, so they differ by a few f32 ULPs; in bf16 both round the
hats as JAX's contraction bodies do and sum in f32, so they differ only
where the other f32 order crosses a bf16 rounding boundary of the output:
a few elements, by one bf16 ULP each.  The samplers' coordinates and
weights are equal: the uncertainties they rank have no ties (asserted),
and a rounding-order difference of one f32 ULP would have to straddle the
selection boundary to change them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jax._src.lib import _jax as xla_ext
from pctrans_tpu.ops.point_sample import (get_uncertain_point_coords as jax_coords,
                                          grid_sample_bilinear as jax_gs,
                                          point_sample as jax_point_sample,
                                          sample_label_onehot as jax_onehot,
                                          uncertain_point_weights as jax_weights)
from pctrans_torch.data.synthetic import make_blob_image
from pctrans_torch.ops.point_sample import (_top_indices, approx_topk_output_size,
                                            get_uncertain_point_coords,
                                            grid_sample_bilinear, point_sample,
                                            sample_label_onehot,
                                            uncertain_point_weights)

torch.set_num_threads(1)

F32_ULPS = 4            # f32 summation order of four products


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_ulp(x):
    """One bf16 ULP at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-38))) - 7)


def _sample_case(C, seed=0, B=2, H=13, W=11, P=400):
    rng = np.random.RandomState(seed)
    img = (rng.randn(B, C, H, W) * 3).astype(np.float32)
    # a share of the points falls outside the map (zero padding) or on it
    x = rng.uniform(-1.5, W + 0.5, (B, P)).astype(np.float32)
    y = rng.uniform(-1.5, H + 0.5, (B, P)).astype(np.float32)
    x[:, :20] = np.round(x[:, :20])                        # integral positions
    return img, x, y


@pytest.mark.parametrize("C", [1, 16])        # the separable and generator bodies
def test_grid_sample_bilinear_f32_matches_jax(C):
    img, x, y = _sample_case(C)
    ref = np.asarray(jax_gs(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    ours = grid_sample_bilinear(_t(img), _t(x), _t(y))
    assert ours.dtype == torch.float32 and ours.shape == (2, C, 400)
    ours = ours.numpy()
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=F32_ULPS * np.spacing(np.abs(img).max()))
    outside = (x < -1) | (x > img.shape[3]) | (y < -1) | (y > img.shape[2])
    assert outside.any() and (ours[np.broadcast_to(outside[:, None], ours.shape)] == 0).all()


@pytest.mark.parametrize("C", [1, 16])
def test_grid_sample_bilinear_bf16_within_one_ulp_of_jax(C):
    """At most 1 in 200 output elements differ, each by one bf16 ULP, and
    each one's f32 sum lies within a few f32 ULPs of a bf16 rounding
    boundary (the sum order decides it)."""
    img, x, y = _sample_case(C, seed=1)
    ref = jax_gs(jnp.asarray(img, jnp.bfloat16), jnp.asarray(x), jnp.asarray(y))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    ours = grid_sample_bilinear(_t(img).bfloat16(), _t(x), _t(y))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    differ = ours != ref
    assert differ.sum() <= ref.size / 200
    assert np.all(np.abs(ours - ref)[differ] <= _bf16_ulp(ref[differ]))
    if differ.any():
        # the port's own f32 sum before its cast: next to the midpoint
        f32 = grid_sample_bilinear(_t(img).bfloat16().float(), _t(x), _t(y)).numpy()
        mid = (ours[differ] + ref[differ]) / 2
        assert np.all(np.abs(f32[differ] - mid) <= 64 * np.spacing(np.abs(mid)))


def test_plain_grid_sample_misses_the_bf16_bound():
    """``F.grid_sample`` on the bf16 map (C=16) rounds none of the hat
    products: it lands more than one bf16 ULP away from JAX's samples in
    many elements, where the port's sampler stays within one."""
    img, x, y = _sample_case(16, seed=1)
    ref = np.asarray(jax_gs(jnp.asarray(img, jnp.bfloat16), jnp.asarray(x),
                            jnp.asarray(y)).astype(jnp.float32))
    H, W = img.shape[2:]
    grid = torch.stack([(_t(x) + 0.5) / W * 2 - 1, (_t(y) + 0.5) / H * 2 - 1], -1)
    plain = F.grid_sample(_t(img).bfloat16(), grid[:, None].bfloat16(), mode="bilinear",
                          padding_mode="zeros", align_corners=False)[:, :, 0]
    miss = np.abs(plain.float().numpy() - ref) > _bf16_ulp(ref)
    assert miss.sum() > ref.size / 100


def test_point_sample_matches_jax():
    rng = np.random.RandomState(2)
    img = rng.randn(3, 1, 14, 10).astype(np.float32)
    coords = rng.rand(3, 50, 2).astype(np.float32)
    ref = np.asarray(jax_point_sample(jnp.asarray(img), jnp.asarray(coords)))
    ours = point_sample(_t(img), _t(coords)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=F32_ULPS * np.spacing(np.abs(img).max()))


@pytest.mark.parametrize("n,k", [(64, 16), (192, 48), (3000, 700), (37632, 9408),
                                 (37632, 100), (12544, 1), (12544, 2), (300, 1)])
def test_approx_topk_output_size_matches_xla(n, k):
    ref = xla_ext.approx_top_k_reduction_output_size(n, 2, k, 0.95, False, -1)[0]
    assert approx_topk_output_size(n, k) == ref


def test_approx_max_k_returns_the_sorted_row_off_the_tpu():
    """What the JAX package's ``topk`` mode gets from ``approx_max_k(...,
    aggregate_to_topk=False)`` on the CPU: ``approx_topk_output_size``
    values in descending order (at the recipe, the whole candidate row;
    the JAX code then strides it by 4)."""
    rng = np.random.RandomState(3)
    x = -np.abs(rng.randn(2, 37632)).astype(np.float32)
    for k in (9408, 100):
        vals, _ = jax.lax.approx_max_k(jnp.asarray(x), k, recall_target=0.95,
                                       aggregate_to_topk=False)
        length = approx_topk_output_size(37632, k)
        assert vals.shape == (2, length)
        np.testing.assert_array_equal(np.asarray(vals), -np.sort(-x, 1)[:, :length])


def test_top_indices_break_ties_as_jax_top_k():
    rng = np.random.RandomState(4)
    x = -rng.randint(0, 7, (3, 500)).astype(np.float32)          # many ties
    x[0, 10] = -0.0
    _, ref = jax.lax.top_k(jnp.asarray(x), 123)
    np.testing.assert_array_equal(_top_indices(_t(x), 123).numpy(), np.asarray(ref))


def _logits(seed, N=6, H=12, W=9):
    return (np.random.RandomState(seed).randn(N, 1, H, W) * 3).astype(np.float32)


def _no_ties(uncert):
    return all(len(np.unique(r)) == r.size for r in uncert)


@pytest.mark.parametrize("exact", [True, False])
def test_get_uncertain_point_coords_matches_jax(exact):
    logits = _logits(5)
    N, num_points, over, imp = logits.shape[0], 64, 3.0, 0.75
    key = jax.random.key(7)
    ref = np.asarray(jax_coords(key, jnp.asarray(logits), num_points, over, imp,
                                exact_topk=exact))
    k1, k2 = jax.random.split(key)
    cand = np.asarray(jax.random.uniform(k1, (2, N, int(num_points * over))))
    fill = np.asarray(jax.random.uniform(k2, (N, num_points - int(imp * num_points), 2)))
    H, W = logits.shape[2:]
    uncert = -np.abs(np.asarray(jax_gs(jnp.asarray(logits), jnp.asarray(cand[0] * W - 0.5),
                                       jnp.asarray(cand[1] * H - 0.5))))[:, 0]
    assert _no_ties(uncert)
    ours = get_uncertain_point_coords(_t(logits), num_points, over, imp, _t(cand),
                                      _t(fill), exact_topk=exact)
    assert ours.shape == (N, num_points, 2)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_approximate_selection_strides_the_sorted_candidates():
    """With more candidates than 128 and k well below them, the approximate
    selection keeps every (length // k)-th of the sorted candidates, not
    the most uncertain ones (ROADMAP.md §C.11)."""
    logits = _logits(6, N=2, H=40, W=40)
    num_points, over, imp = 400, 3.0, 0.25
    key = jax.random.key(8)
    ref = np.asarray(jax_coords(key, jnp.asarray(logits), num_points, over, imp))
    k1, k2 = jax.random.split(key)
    cand = np.asarray(jax.random.uniform(k1, (2, 2, 1200)))
    fill = np.asarray(jax.random.uniform(k2, (2, 300, 2)))
    assert approx_topk_output_size(1200, 100) == 1200
    ours = get_uncertain_point_coords(_t(logits), num_points, over, imp, _t(cand),
                                      _t(fill)).numpy()
    np.testing.assert_array_equal(ours, ref)
    exact = get_uncertain_point_coords(_t(logits), num_points, over, imp, _t(cand),
                                       _t(fill), exact_topk=True).numpy()
    assert (exact[:, :100] != ours[:, :100]).any()


def test_uncertain_point_weights_match_jax():
    logits = _logits(9)
    N, num_points, over, imp = logits.shape[0], 64, 3.0, 0.75
    key = jax.random.key(11)
    rx, ry, rw = (np.asarray(a) for a in jax_weights(key, jnp.asarray(logits),
                                                     num_points, over, imp))
    cand = np.asarray(jax.random.uniform(key, (2, N, int(num_points * over))))
    x, y, w = uncertain_point_weights(_t(logits), num_points, over, imp, _t(cand))
    np.testing.assert_array_equal(x.numpy(), rx)
    np.testing.assert_array_equal(y.numpy(), ry)
    np.testing.assert_allclose(w.numpy(), rw, rtol=1e-6)
    assert (rw > rw.min()).sum() >= int(imp * num_points) * N


def test_sample_label_onehot_equal_jax():
    rng = np.random.RandomState(12)
    seg = np.stack([make_blob_image(rng, (48, 40), n_instances=(3, 6))[1]
                    for _ in range(2)]).astype(np.int32)
    coords = rng.uniform(-0.05, 1.05, (2, 300, 2)).astype(np.float32)
    ref = np.asarray(jax_onehot(jnp.asarray(seg), jnp.asarray(coords), 8))
    ours = sample_label_onehot(_t(seg), _t(coords), 8)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)
