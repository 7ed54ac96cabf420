"""The port's CUDA kernels against their plain twins on the card, at small
odd shapes the CVPPP gate in chip_smoke.py does not cover (ragged query
counts, other head widths, rel coords off, downsampling).

Needs a CUDA card; skips without one.  On the card, from the repo root
(the JAX-free test files run without tests/conftest.py, which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import math

import pytest
import torch

from pctrans_torch.ops import msdeform
from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_backward,
                                        ms_deform_attn_separable,
                                        ms_deform_attn_separable_twin)
from pctrans_torch.ops.render import dynamic_mask_render
from pctrans_torch.ops.resize import resize_bilinear
from pctrans_torch.ops.resize_binarize import resize_bilinear_binarize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("M,D,Lq,P,shapes", [
    (8, 16, 37, 3, [(5, 7), (3, 4), (9, 2)]),
    (4, 8, 1, 3, [(6, 5)]),
    (2, 32, 300, 3, [(11, 13), (6, 7)]),
    (8, 16, 1001, 4, [(17, 16), (34, 32), (67, 63)]),  # the recipe's L=3, P=4 path
    (3, 8, 45, 2, [(1, 9), (6, 1), (4, 4)]),           # levels of width / height 1
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("samples", ["mixed", "nan", "outside"])
def test_msdeform_kernel_matches_twin(dev, M, D, Lq, P, shapes, dtype, tol, samples):
    """K1 against the twin with Lq not a multiple of the block's query tile;
    ``nan``: a third of the locations NaN (both give 0 for them);
    ``outside``: every sample outside its map (an all-zero output)."""
    g = torch.Generator(device=dev).manual_seed(0)
    B, L = 2, len(shapes)
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, device=dev, generator=g).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.4 - 0.2
    if samples == "nan":
        nan = torch.rand(loc.shape, device=dev, generator=g) < 1 / 3
        loc = loc.masked_fill(nan, float("nan"))
    elif samples == "outside":
        loc = torch.where(loc < 0.5, loc - 1.5, loc + 1.0)
    w = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    before = ms_deform_attn.launches
    out = ms_deform_attn(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    ref = ms_deform_attn(value, shapes, loc, w, impl="twin")
    assert out.dtype == dtype and out.shape == (B, Lq, M * D)
    if samples == "outside":
        assert not ref.any() and not out.any()
    else:
        assert bool(out.isfinite().all())
        assert _rel(out, ref) <= tol


@pytest.mark.parametrize("rel_coord", [True, False])
@pytest.mark.parametrize("Q,hw,Cm", [(7, (13, 9), 16), (100, (33, 31), 8),
                                     (5, (4, 6), 4), (300, (20, 26), 16),
                                     (9, (133, 125), 12)])
def test_render_kernel_matches_twin(dev, rel_coord, Q, hw, Cm):
    """K3 against the f32 twin with Q not a multiple of the kernel's 8-query
    chunk and HW not a multiple of its 256-pixel block."""
    g = torch.Generator(device=dev).manual_seed(1)
    B, ch = 2, 8
    cin = Cm + (2 if rel_coord else 0)
    feats = torch.randn(B, hw[0] * hw[1], Cm, device=dev, generator=g)
    inst_xy = torch.rand(B, Q, 2, device=dev, generator=g) * 4 * max(hw)
    w1 = torch.randn(B, Q, ch, cin, device=dev, generator=g) * 0.1
    if rel_coord:
        w1[..., :2] *= 0.05
    w2 = torch.randn(B, Q, ch, ch, device=dev, generator=g) * 0.3
    w3 = torch.randn(B, Q, 1, ch, device=dev, generator=g) * 0.3
    b1, b2 = (torch.randn(B, Q, ch, device=dev, generator=g) for _ in range(2))
    b3 = torch.randn(B, Q, 1, device=dev, generator=g)
    args = (feats, inst_xy, w1, w2, w3, b1, b2, b3, hw, 4, rel_coord)
    out = dynamic_mask_render(*args)
    torch.cuda.synchronize()
    assert _rel(out, dynamic_mask_render(*args, impl="twin")) <= 1e-5


@pytest.mark.parametrize("shape,size,margin", [
    ((2, 3, 17, 21), (68, 84), 1e-5),
    ((1, 4, 13, 16), (50, 61), 1e-5),
    ((2, 2, 40, 30), (13, 11), 1e-5),      # downsample
    ((1, 3, 7, 9), (1, 20), 1e-5),         # H = 1
    # the eval path's full-Q re-run, held to chip_smoke.py's K4 gate: at
    # 133 -> 530 the kernel's tables (f64 coordinates rounded once) and
    # F.interpolate's f32 coordinates part by up to ~2e-5 in the logit
    ((4, 100, 133, 125), (530, 500), 1e-4),
])
def test_resize_binarize_kernel_matches_twin(dev, shape, size, margin):
    """K4 against the twin, up to bytes whose f32 logit is within
    ``margin`` of the threshold; W = 61 and 11 are not multiples of 4
    (byte stores)."""
    g = torch.Generator(device=dev).manual_seed(2)
    t = math.log(0.69 / 0.31)
    x = torch.randn(*shape, device=dev, generator=g) * 2.0
    before = resize_bilinear_binarize.launches
    out = resize_bilinear_binarize(x, size, t)
    torch.cuda.synchronize()
    assert resize_bilinear_binarize.launches == before + 1
    assert out.dtype == torch.uint8 and out.shape == shape[:2] + size
    ref = resize_bilinear_binarize(x, size, t, impl="twin")
    logits = resize_bilinear(x, size)
    differ = out != ref
    assert int(differ.sum()) <= 1e-4 * out.numel()
    assert bool(((logits[differ] - t).abs() <= margin).all())


def test_render_kernel_refuses_what_it_cannot_hold(dev):
    """The kernel holds ch == 8 channels and Cm <= 16 feature columns in its
    mma fragments: more raises.  A feature map at an odd offset is read as
    it is (scalar loads, no alignment needed)."""
    B, Q, hw, ch = 1, 3, (4, 5), 8
    z = lambda *s: torch.rand(*s, device=dev)
    with pytest.raises(ValueError, match="Cm <= 16"):
        dynamic_mask_render(z(B, 20, 20), z(B, Q, 2), z(B, Q, ch, 22), z(B, Q, ch, ch),
                            z(B, Q, 1, ch), z(B, Q, ch), z(B, Q, ch), z(B, Q, 1),
                            hw, 4, True)
    with pytest.raises(ValueError, match="ch == 8"):
        dynamic_mask_render(z(B, 20, 8), z(B, Q, 2), z(B, Q, 4, 10), z(B, Q, 4, 4),
                            z(B, Q, 1, 4), z(B, Q, 4), z(B, Q, 4), z(B, Q, 1),
                            hw, 4, True)
    feats = z(B * 20 * 16 + 1)[1:].reshape(B, 20, 16)
    args = (feats, z(B, Q, 2), z(B, Q, ch, 18), z(B, Q, ch, ch), z(B, Q, 1, ch),
            z(B, Q, ch), z(B, Q, ch), z(B, Q, 1), hw, 4, True)
    out = dynamic_mask_render(*args)
    assert _rel(out, dynamic_mask_render(*args, impl="twin")) <= 1e-5


def test_msdeform_kernel_refuses_what_it_cannot_load(dev):
    """K1 loads a head's channels in 16-byte groups from 16-byte aligned
    tensors: D not a multiple of 8 (bf16) or 4 (f32), or a value tensor at
    an unaligned offset, raises; nothing falls back to the twin."""
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=dev)
    w = torch.rand(1, 5, 2, 1, 2, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        ms_deform_attn(torch.randn(1, 6, 2, 4, device=dev).bfloat16(), [(2, 3)], loc, w)
    with pytest.raises(ValueError, match="multiple of 4"):
        ms_deform_attn(torch.randn(1, 6, 2, 6, device=dev), [(2, 3)], loc, w)
    value = torch.randn(6 * 2 * 8 + 1, device=dev)[1:].reshape(1, 6, 2, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ms_deform_attn(value, [(2, 3)], loc, w)


def test_msdeform_kernel_refuses_grad(dev):
    """A raw K1 launch refuses a tensor that needs grad: autograd reaches
    the kernels only through MSDeformAttnFunction."""
    value = torch.randn(1, 6, 2, 4, device=dev, requires_grad=True)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=dev)
    w = torch.rand(1, 5, 2, 1, 2, device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        msdeform._launch_forward(value, [(2, 3)], loc, w)


def _on_grid(loc, shapes, share, g):
    """Put ``share`` of the samples on exactly integral pixel coordinates."""
    loc = loc.clone()
    for lid, (H, W) in enumerate(shapes):
        size = torch.tensor([W, H], dtype=torch.float32, device=loc.device)
        k = torch.randint(-1, max(H, W) + 1, loc[:, :, :, lid].shape,
                          device=loc.device, generator=g)
        pick = torch.rand(loc[:, :, :, lid].shape, device=loc.device,
                          generator=g) < share
        loc[:, :, :, lid] = torch.where(pick, (k + 0.5) / size, loc[:, :, :, lid])
    return loc


@pytest.mark.parametrize("M,D,Lq,shapes", [
    (8, 16, 37, [(5, 7), (3, 4), (9, 2)]),
    (4, 8, 1, [(6, 5)]),
    (2, 32, 300, [(11, 13), (6, 7)]),
    (3, 16, 129, [(4, 4), (2, 3)]),          # 48-thread rows: a partial warp
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("on_grid", [False, True])
def test_msdeform_backward_kernel_matches_twin_autograd(dev, M, D, Lq, shapes,
                                                        dtype, tol, on_grid):
    """K2 against the twin's autograd, with Lq not a multiple of the block's
    queries and, on_grid, half the samples at integral pixel coordinates
    (where both give a zero location derivative)."""
    g = torch.Generator(device=dev).manual_seed(3)
    B, L, P = 2, len(shapes), 3
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, device=dev, generator=g).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.4 - 0.2
    if on_grid:
        loc = _on_grid(loc, shapes, 0.5, g)
    w = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    gout = torch.randn(B, Lq, M * D, device=dev, generator=g).to(dtype)

    def grads(impl):
        prim = [t.clone().requires_grad_() for t in (value, loc, w)]
        out = ms_deform_attn(prim[0], shapes, prim[1], prim[2], impl=impl)
        out.backward(gout)
        return [p.grad for p in prim]

    before = (ms_deform_attn.launches, ms_deform_attn_backward.launches)
    ours = grads(None)
    torch.cuda.synchronize()
    assert (ms_deform_attn.launches, ms_deform_attn_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = grads("twin")
    for name, a, b in zip(("value", "locations", "weights"), ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) <= tol, name


@pytest.mark.parametrize("M,D,Lq,shapes", [
    (8, 16, 37, [(5, 7), (3, 4), (9, 2)]),
    (4, 8, 1, [(6, 5)]),
    (2, 32, 300, [(11, 13), (6, 7)]),
    (3, 8, 129, [(40, 70), (2, 3)]),         # 5 K tiles; several passes in f32
    (2, 32, 70, [(90, 100), (3, 5)]),        # several passes in both dtypes
    (8, 16, 1001, [(17, 16), (34, 32), (67, 63)]),   # the eval levels, one bf16 pass
])
@pytest.mark.parametrize("dtype,tol,corner_tol", [(torch.float32, 1e-5, 1e-5),
                                                  (torch.bfloat16, 1e-4, 1e-2)])
@pytest.mark.parametrize("samples", ["mixed", "nan", "shared_corner"])
def test_separable_kernel_matches_both_twins(dev, M, D, Lq, shapes, dtype, tol,
                                             corner_tol, samples):
    """K5 against its separable twin (bf16: both round hat_x alike, so only
    sum order and the output's rounding differ) and the 4-corner twin (bf16:
    it takes hat_x in f32), with samples outside the map and Lq not a
    multiple of the 16-query tile.  ``nan``: a third of the samples NaN
    (zero in K5 and the 4-corner twin); ``shared_corner``: every query of a
    head samples the same 2x2 cells of the first level, as neighbouring
    queries of the model do."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, L, P = 2, len(shapes), 3
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, device=dev, generator=g).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.4 - 0.2
    if samples == "nan":
        loc = loc.masked_fill(torch.rand(loc.shape, device=dev, generator=g) < 1 / 3,
                              float("nan"))
    elif samples == "shared_corner":
        H, W = shapes[0]
        size = torch.tensor([W, H], dtype=torch.float32, device=dev)
        corner = torch.randint(0, max(1, min(H, W) - 1), (B, 1, M, 1, 2), device=dev,
                               generator=g)
        frac = torch.rand(B, Lq, M, P, 2, device=dev, generator=g)
        loc[:, :, :, 0] = (corner + frac + 0.5) / size
    w = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    before = (ms_deform_attn.launches, ms_deform_attn_separable.launches)
    out = ms_deform_attn(value, shapes, loc, w, impl="pallas")
    torch.cuda.synchronize()
    assert (ms_deform_attn.launches, ms_deform_attn_separable.launches) == \
        (before[0], before[1] + 1)
    assert out.dtype == dtype and out.shape == (B, Lq, M * D)
    assert bool(out.isfinite().all())
    corner = ms_deform_attn(value, shapes, loc, w, impl="twin")
    assert _rel(out, corner) <= corner_tol
    if samples != "nan":                     # the separable twin gives NaN there
        assert _rel(out, ms_deform_attn_separable_twin(value, shapes, loc, w)) <= tol


@pytest.mark.parametrize("on_grid", [False, True])
def test_separable_function_backward_is_k2(dev, on_grid):
    """Under autograd the pallas path runs K5 forward and K2 backward; its
    gradients equal the 4-corner twin's autograd (integral samples included:
    both take the hat derivative 0 there)."""
    g = torch.Generator(device=dev).manual_seed(5)
    shapes = [(5, 7), (3, 4)]
    B, M, D, Lq, L, P = 2, 8, 16, 70, 2, 4
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, device=dev, generator=g)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.4 - 0.2
    if on_grid:
        loc = _on_grid(loc, shapes, 0.5, g)
    w = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    gout = torch.randn(B, Lq, M * D, device=dev, generator=g)

    def grads(impl):
        prim = [t.clone().requires_grad_() for t in (value, loc, w)]
        ms_deform_attn(prim[0], shapes, prim[1], prim[2], impl=impl).backward(gout)
        return [p.grad for p in prim]

    before = (ms_deform_attn_separable.launches, ms_deform_attn_backward.launches)
    ours = grads("pallas")
    torch.cuda.synchronize()
    assert (ms_deform_attn_separable.launches, ms_deform_attn_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("value", "locations", "weights"), ours, grads("twin")):
        assert _rel(a, b) <= 1e-5, name


def test_separable_kernel_refuses_what_it_cannot_stage(dev):
    """K5 takes a head's channels in n8 tensor-core tiles and stages whole
    rows of a level in shared memory: D = 4 or 6, or a row wider than the
    block's shared memory, raises; nothing falls back to the twin."""
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=dev)
    w = torch.rand(1, 5, 2, 1, 2, device=dev)
    for D in (4, 6):
        with pytest.raises(ValueError, match="D must be"):
            ms_deform_attn_separable(torch.randn(1, 6, 2, D, device=dev), [(2, 3)], loc, w)
    with pytest.raises(ValueError, match="shared memory"):
        ms_deform_attn_separable(torch.randn(1, 2 * 2000, 2, 32, device=dev),
                                 [(2, 2000)], loc, w)


def _backward_grads(value, shapes, loc, w, gout, impl):
    prim = [t.clone().requires_grad_() for t in (value, loc, w)]
    ms_deform_attn(prim[0], shapes, prim[1], prim[2], impl=impl).backward(gout)
    return [p.grad for p in prim]


def _check_backward(ours, ref, tol, loc):
    """K2's gradients against the twin's autograd.  Where a location is
    NaN the twin's location and weight gradients are NaN; K2 gives 0 there
    (the sample contributes nothing), and the rest is compared."""
    nan_sample = torch.isnan(loc).any(-1)
    for name, a, b in zip(("value", "locations", "weights"), ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        nan = torch.isnan(b)
        if nan.any():
            where = nan_sample[..., None].expand_as(b) if name == "locations" else nan_sample
            assert bool(where[nan].all()) and not a[nan].any(), name
            a, b = a[~nan], b[~nan]
        if not b.any():
            assert not a.any(), name
        else:
            assert _rel(a, b) <= tol, name


@pytest.mark.parametrize("samples", ["contention", "nan", "outside", "integral",
                                     "big_and_small_levels"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_msdeform_backward_kernel_edge_samples(dev, samples, dtype, tol):
    """K2 at the recipe's heads (M=8, D=16, L=3, P=4) on the inputs that
    stress it: every query of a head in the same 2x2 cells of the coarsest
    level (its adds collide); a third of the locations NaN; every sample
    outside its map (all gradients 0); half the samples on integral pixel
    coordinates (hat derivative 0); a 120x100 level beside a 4x4 one.  The
    4x4 level takes 75 samples per position, so its adds are summed per
    warp first (``backward_aggregated_levels``); the others are not."""
    g = torch.Generator(device=dev).manual_seed(6)
    shapes = ([(120, 100), (4, 4), (9, 7)] if samples == "big_and_small_levels"
              else [(4, 4), (14, 14), (7, 9)])
    B, M, D, Lq, L, P = 2, 8, 16, 301, 3, 4
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, device=dev, generator=g).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.4 - 0.2
    if samples == "contention":
        H, W = shapes[0]
        size = torch.tensor([W, H], dtype=torch.float32, device=dev)
        corner = torch.randint(1, min(H, W) - 2, (B, 1, M, 1, 2), device=dev, generator=g)
        frac = torch.rand(B, Lq, M, P, 2, device=dev, generator=g)
        loc[:, :, :, 0] = (corner + frac + 0.5) / size
    elif samples == "nan":
        loc = loc.masked_fill(torch.rand(loc.shape, device=dev, generator=g) < 1 / 3,
                              float("nan"))
    elif samples == "outside":
        loc = torch.where(loc < 0.5, loc - 1.5, loc + 1.0)
    elif samples == "integral":
        loc = _on_grid(loc, shapes, 0.5, g)
    w = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    gout = torch.randn(B, Lq, M * D, device=dev, generator=g).to(dtype)
    before = ms_deform_attn_backward.launches
    ours = _backward_grads(value, shapes, loc, w, gout, None)
    torch.cuda.synchronize()
    assert ms_deform_attn_backward.launches == before + 1
    _check_backward(ours, _backward_grads(value, shapes, loc, w, gout, "twin"), tol, loc)


@pytest.mark.parametrize("D", [8, 16, 32])
@pytest.mark.parametrize("Lq", [1, 37, 300])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_msdeform_backward_kernel_head_widths(dev, D, Lq, dtype, tol):
    """K2 at head widths 8, 16 and 32 in both dtypes (2 to 8 lanes per
    query and head), with Lq leaving the last query tile, and the last
    warp of a block, partly empty; at Lq = 300 the 3x4 level's adds are
    summed per warp first."""
    g = torch.Generator(device=dev).manual_seed(7)
    shapes = [(3, 4), (9, 11)]
    B, M, L, P = 2, 4, 2, 3
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, device=dev, generator=g).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.4 - 0.2
    w = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    gout = torch.randn(B, Lq, M * D, device=dev, generator=g).to(dtype)
    ours = _backward_grads(value, shapes, loc, w, gout, None)
    torch.cuda.synchronize()
    _check_backward(ours, _backward_grads(value, shapes, loc, w, gout, "twin"), tol, loc)


def test_msdeform_backward_kernel_refuses_what_it_cannot_take(dev):
    """K2 takes whole runs of 4 channels per thread: a head width it cannot
    split into such runs raises; nothing falls back to the twin."""
    value = torch.randn(1, 6, 2, 6, device=dev)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=dev)
    w = torch.rand(1, 5, 2, 1, 2, device=dev)
    with pytest.raises(ValueError, match="power of two"):
        ms_deform_attn_backward(value, [(2, 3)], loc, w, torch.randn(1, 5, 12, device=dev))
