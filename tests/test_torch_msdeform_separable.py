"""K5's plain version (the separable twin) and its gradient through
``ms_deform_attn_separable``, against the JAX package's
``ms_deform_attn_core_pallas`` (``_level_kernel`` in interpret mode, as
``tests/test_ops.py`` runs it on the CPU); ``ms_deform_attn`` takes K1's
path (the 4-corner twin on the CPU) whatever the environment says.

Tolerances: f32 on both sides, other summation orders; the forward at
rel-Fro 1e-5, the gradient at rel-Fro 1e-4 (its sums run over every pixel
of a level).  In bf16 both round hat_x to bf16 before stage 1 and sum in
f32, so they differ only where another f32 summation order crosses a bf16
rounding boundary of the output: a few elements, by one bf16 ULP each.

``test_k5_arithmetic_rehearsal_*`` emulates the CUDA kernel's tile plan
(``csrc/msdeform_separable.cu``) on the CPU and holds it against the twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.ops.msdeform_pallas import ms_deform_attn_core_pallas
from pctrans_torch.config import ModelConfig
from pctrans_torch.models import PCTransModel
from pctrans_torch.models import pixel_decoder
from pctrans_torch.models.pixel_decoder import MSDeformAttn
from pctrans_torch.ops import msdeform
from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_separable,
                                        ms_deform_attn_separable_twin,
                                        ms_deform_attn_twin, separable_plan,
                                        separable_row_stride)

torch.set_num_threads(1)

SHAPES = ((6, 5), (3, 7), (2, 2))      # widths and heights not powers of two
GRID_SHAPES = ((3, 8), (5, 4))         # power-of-two widths: (k + 0.5) / W is exact
FWD_REL, GRAD_REL = 1e-5, 1e-4


def _inputs(seed, shapes=SHAPES, B=2, Lq=37, M=2, D=8, P=3):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    locs = rng.uniform(-0.15, 1.15, (B, Lq, M, L, P, 2)).astype(np.float32)
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    g = rng.randn(B, Lq, M * D).astype(np.float32)
    return value, locs, attn, g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_k5(value, shapes, locs, attn):
    return ms_deform_attn_core_pallas(jnp.asarray(value), tuple(shapes),
                                      jnp.asarray(locs), jnp.asarray(attn))


def _jax_vjp(value, shapes, locs, attn, g):
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_core_pallas(v, tuple(shapes), l, a),
                     jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attn))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _torch_grads(value, shapes, locs, attn, g, fn=ms_deform_attn_separable):
    prim = [torch.from_numpy(a).requires_grad_() for a in (value, locs, attn)]
    out = fn(prim[0], list(shapes), prim[1], prim[2])
    (out * torch.from_numpy(g)).sum().backward()
    return [p.grad.numpy() for p in prim]


@pytest.mark.parametrize("Lq", [37, 300])        # one chunk, and ragged chunks
def test_separable_twin_matches_jax_k5_and_the_four_corner_twin(Lq):
    value, locs, attn, _ = _inputs(0, Lq=Lq)
    ref = np.asarray(_jax_k5(value, SHAPES, locs, attn))
    args = [torch.from_numpy(a) for a in (value, locs, attn)]
    ours = ms_deform_attn_separable_twin(args[0], list(SHAPES), args[1], args[2])
    corner = ms_deform_attn_twin(args[0], list(SHAPES), args[1], args[2])
    outside = (locs < -0.5 / 7) | (locs > 1 + 0.5 / 7)
    assert outside.mean() > 0.05                 # samples off the map
    assert ours.shape == (2, Lq, 16) and ours.dtype == torch.float32
    assert _rel(ours.numpy(), ref) <= FWD_REL
    assert _rel(ours.numpy(), corner.numpy()) <= FWD_REL


def test_separable_twin_keeps_the_value_dtype_and_sums_in_f32():
    value, locs, attn, _ = _inputs(1)
    v = torch.from_numpy(value).bfloat16()
    l, a = torch.from_numpy(locs), torch.from_numpy(attn)
    out = ms_deform_attn_separable_twin(v, list(SHAPES), l, a)
    ref = ms_deform_attn_twin(v, list(SHAPES), l, a)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), ref.float().numpy()) <= 1e-2


BF16_SHAPES = ((17, 16), (9, 8), (5, 4))


def _bf16_ulp(x):
    """One bf16 ULP at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-38))) - 7)


@pytest.mark.parametrize("Lq,max_rel", [(150, 1e-6), (300, 1e-5)])   # 300: ragged chunks
def test_separable_twin_bf16_rounds_hat_x_as_jax_k5(Lq, max_rel):
    """In bf16 the twin rounds hat_x to the value dtype before stage 1, as
    JAX's ``_level_kernel`` does (``hx.astype(v.dtype)``): at most 1 in
    2000 output elements differ, each by one bf16 ULP (f32 summation order
    crossing a rounding boundary).  rel-Fro is about n * ULP / ||out||: one
    flip of a typical element at Lq=300 weighs ~4e-6.  Before the repair
    (hat_x in f32) 7,255 of the 19,200 elements at Lq=150 differed, rel-Fro
    2.4e-3 (``ROADMAP.md`` §C.10)."""
    rng = np.random.RandomState(0)
    B, M, D, P, L = 2, 4, 16, 4, len(BF16_SHAPES)
    S = sum(h * w for h, w in BF16_SHAPES)
    value = rng.randn(B, S, M, D).astype(np.float32)
    locs = rng.rand(B, Lq, M, L, P, 2).astype(np.float32)
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    ref = ms_deform_attn_core_pallas(jnp.asarray(value, jnp.bfloat16), BF16_SHAPES,
                                     jnp.asarray(locs), jnp.asarray(attn))
    ref = np.asarray(ref.astype(jnp.float32))
    ours = ms_deform_attn_separable_twin(torch.from_numpy(value).bfloat16(),
                                         list(BF16_SHAPES), torch.from_numpy(locs),
                                         torch.from_numpy(attn))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    differ = ours != ref
    assert differ.sum() <= ref.size / 2000
    assert np.all(np.abs(ours - ref)[differ] <= _bf16_ulp(ref[differ]))
    assert _rel(ours, ref) <= max_rel


def test_pallas_path_gradient_matches_jax_k5_off_the_grid():
    value, locs, attn, g = _inputs(2)
    ref = _jax_vjp(value, SHAPES, locs, attn, g)
    ours = _torch_grads(value, SHAPES, locs, attn, g)
    for name, a, b in zip(("value", "locations", "weights"), ours, ref):
        assert _rel(a, b) <= GRAD_REL, name
    # the 4-corner twin's autograd (K2's plain version) agrees as well
    corner = _torch_grads(value, SHAPES, locs, attn, g, fn=ms_deform_attn_twin)
    for name, a, b in zip(("value", "locations", "weights"), ours, corner):
        assert _rel(a, b) <= GRAD_REL, name


def test_integral_x_coordinate_port_gives_zero_jax_gives_minus_v():
    """Samples whose x pixel coordinate is an exact integer k inside the
    map.  The port (separable twin's autograd, K2's convention) gives a zero
    x derivative there.  JAX's K5 VJP differentiates ``relu(1 - |x - s|)``
    with ``abs'(0) = 1``: d out / dx = -w * sum_h hat_y(h) * V[h, k], times
    W through ``x = loc * W - 0.5`` (ROADMAP.md §C.7)."""
    B, Lq, M, D, P = 1, 16, 2, 4, 2
    value, locs, attn, g = _inputs(3, GRID_SHAPES, B=B, Lq=Lq, M=M, D=D, P=P)
    rng = np.random.RandomState(4)
    ks = []
    for lid, (H, W) in enumerate(GRID_SHAPES):
        k = rng.randint(0, W, (B, Lq, M, P))
        locs[:, :, :, lid, :, 0] = ((k + 0.5) / W).astype(np.float32)
        locs[:, :, :, lid, :, 1] = rng.uniform(0.05, 0.95, (B, Lq, M, P))
        ks.append(k)
    assert jax.grad(jnp.abs)(0.0) == 1.0 and jax.grad(jax.nn.relu)(0.0) == 0.0

    ref = _jax_vjp(value, GRID_SHAPES, locs, attn, g)
    ours = _torch_grads(value, GRID_SHAPES, locs, attn, g)
    assert np.all(ours[1][..., 0] == 0.0)
    # everything else agrees
    assert _rel(ours[0], ref[0]) <= GRAD_REL
    assert _rel(ours[2], ref[2]) <= GRAD_REL
    assert _rel(ours[1][..., 1], ref[1][..., 1]) <= GRAD_REL

    expect = np.zeros(ref[1].shape[:-1], np.float64)      # [B, Lq, M, L, P]
    gm = g.reshape(B, Lq, M, D).astype(np.float64)
    start = 0
    for lid, (H, W) in enumerate(GRID_SHAPES):
        v = value[:, start:start + H * W].reshape(B, H, W, M, D).astype(np.float64)
        y = locs[:, :, :, lid, :, 1].astype(np.float64) * H - 0.5
        hy = np.maximum(0.0, 1.0 - np.abs(y[..., None] - np.arange(H)))  # [B, Lq, M, P, H]
        for b, q, m, p in np.ndindex(B, Lq, M, P):
            col = v[b, :, ks[lid][b, q, m, p], m]                      # [H, D]
            sample = hy[b, q, m, p] @ col                               # [D]
            expect[b, q, m, lid, p] = -W * attn[b, q, m, lid, p] * (gm[b, q, m] @ sample)
        start += H * W
    assert np.abs(expect).max() > 1.0
    np.testing.assert_allclose(ref[1][..., 0], expect, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ dispatch
def _spy(monkeypatch):
    calls = []
    for name in ("ms_deform_attn_twin", "ms_deform_attn_separable_twin"):
        fn = getattr(msdeform, name)
        monkeypatch.setattr(msdeform, name,
                            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    return calls


def test_separable_wrapper_matches_the_four_corner_twin_on_the_models_inputs(monkeypatch):
    """K5's path on the CPU (``ms_deform_attn_separable``: its twin) on the
    (value, locations, weights) that the tiny model's encoder layers give
    the ms-deform op, with samples off the pixel grid, against the 4-corner
    twin that the model's own calls take."""
    cfg = ModelConfig(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10,
                      nheads=4, dim_feedforward=64, enc_layers=2, dec_layers=3,
                      backbone_depth=14, head_norm="GN")
    model = PCTransModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for layer in model.pixel_decoder.modules():
            if isinstance(layer, MSDeformAttn):          # samples off the grid
                layer.sampling_offsets.weight.normal_(0.0, 0.05)
    images = torch.from_numpy(np.random.RandomState(6).randn(2, 48, 40, 3).astype(np.float32))
    inputs = []

    def keep(value, shapes, loc, w):
        inputs.append((value, tuple(shapes), loc, w))
        return ms_deform_attn(value, shapes, loc, w)

    monkeypatch.setattr(pixel_decoder, "ms_deform_attn", keep)
    with torch.no_grad():
        model(images)
        calls = _spy(monkeypatch)
        assert len(inputs) == cfg.enc_layers
        for value, shapes, loc, w in inputs:
            out = ms_deform_attn_separable(value, shapes, loc, w)
            assert _rel(out.numpy(), ms_deform_attn_twin(value, shapes, loc, w).numpy()) <= 1e-4
    assert calls == ["ms_deform_attn_separable_twin"] * cfg.enc_layers


def test_the_variable_no_longer_selects_a_formulation(monkeypatch):
    """``$PCTRANS_MSDA_IMPL=pallas`` chose K5 before; ``ms_deform_attn`` now
    reads no environment and takes the 4-corner twin on the CPU."""
    value, locs, attn, _ = (torch.from_numpy(a) for a in _inputs(5, Lq=9))
    monkeypatch.delenv("PCTRANS_MSDA_IMPL", raising=False)
    want = ms_deform_attn(value, list(SHAPES), locs, attn)
    calls = _spy(monkeypatch)
    monkeypatch.setenv("PCTRANS_MSDA_IMPL", "pallas")
    got = ms_deform_attn(value, list(SHAPES), locs, attn)
    assert calls == ["ms_deform_attn_twin"] and torch.equal(got, want)


# ------------------------------------------------ K5 arithmetic rehearsal
def _kc(dtype, D):
    """K tiles whose A fragments a warp holds at once (``KC`` in the kernel)."""
    return 1 if dtype == torch.float32 else (2 if D > 16 else 4)


def _tf32(x):
    """cvt.rna.tf32.f32 on finite f32: nearest, ties away, 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(c, a, b, dtype):
    """One warp-wide product into the f32 accumulator c [16, n]: bf16
    operands exact in f64 (hat_x is already rounded); f32 as 3xTF32, small
    terms first, each product exact in f64 and rounded into c."""
    if dtype == torch.bfloat16:
        return (c.double() + a.double() @ b.double()).float()
    (ah, al), (bh, bl) = _split(a), _split(b)
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        c = (c.double() + x.double() @ y.double()).float()
    return c


def _k5_emulate(value, shapes, loc, w, budget=separable_plan.__defaults__[0], skip=True):
    """The kernel's arithmetic, tile by tile: passes and row bands from
    ``separable_plan``; per (b, m), 16-query tile, band and point p the
    rows' pixel coordinates (outside or NaN -> -4, zero hats), the warp's
    row and column ranges, A tiles of 16 hat_x columns (rounded to the value
    dtype) in chunks of KC, a K tile left out when its A is all zero and a
    row h when hat_y is zero for all 16 rows (``skip``), stage 2 as
    fma(hat_y * w, t, acc) in f32, an f32 partial between passes, one store
    in the value dtype."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    dt = value.dtype
    passes = separable_plan(shapes, D, value.element_size(), budget)
    starts = np.cumsum([0] + [h * w_ for h, w_ in shapes])
    out = torch.zeros(B, Lq, M, D)
    for b, m in np.ndindex(B, M):
        for q0 in range(0, Lq, 16):
            rows = torch.arange(q0, q0 + 16)
            live = rows < Lq
            acc = torch.zeros(16, D)
            for segs in passes:
                for lid, h0, h1, _ in segs:
                    H, W = shapes[lid]
                    v = value[b, starts[lid]:starts[lid + 1], m].float().reshape(H, W, D)
                    Wp = 16 * -(-W // 16)
                    vp = torch.zeros(H, Wp, D)
                    vp[:, :W] = v
                    for p in range(P):
                        c = torch.zeros(16, 2)
                        ww = torch.zeros(16)
                        c[live] = loc[b, rows[live], m, lid, p]
                        ww[live] = w[b, rows[live], m, lid, p]
                        x = c[:, 0] * W - 0.5
                        y = c[:, 1] * H - 0.5
                        inside = live & (x > -1) & (x < W) & (y > -1) & (y < H)
                        x = torch.where(inside, x, torch.tensor(-4.0))
                        y = torch.where(inside, y, torch.tensor(-4.0))
                        ww = torch.where(inside, ww, torch.tensor(0.0))
                        fy, fx = torch.floor(y).long(), torch.floor(x).long()
                        lo, hi = fy.clamp(min=h0), (fy + 1).clamp(max=h1 - 1)
                        reach = inside & (lo <= hi)
                        if not reach.any():
                            continue
                        hlo, hhi = int(lo[reach].min()), int(hi[reach].max())
                        clo = int(fx[reach].clamp(min=0).min())
                        chi = int((fx[reach] + 1).clamp(max=W - 1).max())
                        if not skip:
                            hlo, hhi, clo, chi = h0, h1 - 1, 0, Wp - 1
                        for k0 in range(clo // 16, chi // 16 + 1, _kc(dt, D)):
                            tiles = []
                            for k in range(k0, k0 + _kc(dt, D)):
                                s = torch.arange(16 * k, 16 * k + 16)
                                a = torch.relu(1 - (x[:, None] - s).abs())
                                a = torch.where(s < W, a, torch.tensor(0.0)).to(dt).float()
                                if (a != 0).any() or (not skip and k < Wp // 16):
                                    tiles.append((k, a))
                            for h in range(hlo, hhi + 1):
                                hy = torch.relu(1 - (y - h).abs())
                                if skip and not (hy != 0).any():
                                    continue
                                t = torch.zeros(16, D)
                                for k, a in tiles:
                                    t = _mma(t, a, vp[h, 16 * k:16 * k + 16], dt)
                                acc = torch.addcmul(acc, (hy * ww)[:, None], t)
            out[b, q0:q0 + 16, m] = acc[:min(16, Lq - q0)]
    return out.reshape(B, Lq, M * D).to(dt)


def _rehearsal_inputs(seed, shapes, B=1, Lq=37, M=2, D=8, P=3, dtype=torch.bfloat16,
                      samples="mixed"):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).to(dtype)
    if samples == "neighbours":
        # the model's inputs: query q near pixel q of the finest level, the
        # points at fixed offsets of a few pixels per head
        H, W = shapes[-1]
        base = np.stack([(np.arange(Lq) % W + 0.5) / W,
                         (np.arange(Lq) // W % H + 0.5) / H], -1)
        off = rng.uniform(-3, 3, (1, 1, M, L, P, 2)) / np.array([W, H])
        locs = (base[None, :, None, None, None] + off
                + rng.uniform(-0.3, 0.3, (B, Lq, M, L, P, 2)) / np.array([W, H]))
    else:
        locs = rng.uniform(-0.15, 1.15, (B, Lq, M, L, P, 2))
        if samples == "nan":
            locs[rng.rand(*locs.shape) < 0.3] = np.nan
    attn = rng.rand(B, Lq, M, L, P)
    return (value, list(shapes), torch.from_numpy(locs.astype(np.float32)),
            torch.from_numpy(attn.astype(np.float32)))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-5), (torch.float32, 1e-6)])
@pytest.mark.parametrize("D", [8, 16, 32])
def test_k5_arithmetic_rehearsal_matches_the_twin(dtype, tol, D):
    """The emulated kernel against the separable twin, with samples off the
    map, Lq = 37 (a partial last tile) and levels of width 16, 20 and 33
    (a partial K tile, several K chunks in f32).  bf16: both round hat_x
    alike and sum in f32; the output is compared before its bf16 rounding
    would hide a difference, so through the f32 values."""
    value, shapes, loc, w = _rehearsal_inputs(7, ((3, 16), (4, 20), (2, 33)), D=D,
                                              dtype=dtype)
    ours = _k5_emulate(value.float().to(dtype), shapes, loc, w)
    ref = ms_deform_attn_separable_twin(value, shapes, loc, w)
    assert ours.dtype == dtype
    if dtype == torch.bfloat16:
        differ = ours != ref
        assert differ.sum() <= 2
        assert bool((((ours - ref).float().abs())[differ]
                     <= torch.from_numpy(_bf16_ulp(ref.float()[differ].numpy()))).all())
    assert _rel(ours.float().numpy(), ref.float().numpy()) <= tol


@pytest.mark.parametrize("samples", ["mixed", "neighbours", "nan"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_arithmetic_rehearsal_skip_leaves_out_only_zeros(samples, dtype):
    """The tile skip against the dense contraction (every row and K tile of
    the map): bit-equal on finite values.  ``neighbours`` (the model's
    kind of input) leaves out most tiles; ``nan`` puts NaN locations in,
    which give zero hats in both, as in the 4-corner twin."""
    value, shapes, loc, w = _rehearsal_inputs(8, ((5, 6), (9, 18)), Lq=40,
                                              dtype=dtype, samples=samples)
    ours = _k5_emulate(value, shapes, loc, w)
    assert torch.equal(ours, _k5_emulate(value, shapes, loc, w, skip=False))
    corner = ms_deform_attn_twin(value, shapes, loc, w)
    assert bool(ours.isfinite().all())
    assert _rel(ours.float().numpy(), corner.float().numpy()) <= (
        1e-2 if dtype == torch.bfloat16 else 1e-5)


def test_k5_arithmetic_rehearsal_passes_split_the_map():
    """A budget that holds 5 staged rows: the 9x18 level is split over
    passes, with an f32 partial between them; the result is the one-pass
    result up to f32 summation order."""
    value, shapes, loc, w = _rehearsal_inputs(9, ((3, 4), (9, 18)), Lq=21,
                                              dtype=torch.float32)
    row = 8 * separable_row_stride(18, 4) * 4
    passes = separable_plan(shapes, 8, 4, 5 * row)
    assert len(passes) == 3 and [s[0] for s in passes[1]] == [1]
    ours = _k5_emulate(value, shapes, loc, w, budget=5 * row)
    assert _rel(ours.numpy(), _k5_emulate(value, shapes, loc, w).numpy()) <= 1e-6


def test_separable_plan_stages_the_recipe_maps_in_one_bf16_pass():
    eval_shapes, train_shapes = [(17, 16), (34, 32), (67, 63)], [(14, 14), (28, 28), (56, 56)]
    for shapes, smem in ((eval_shapes, 210_944), (train_shapes, 175_616)):
        passes = separable_plan(shapes, 16, 2)
        assert passes == [[(l, 0, h, off) for l, ((h, _), off) in enumerate(
            zip(shapes, np.cumsum([0] + [h * 16 * separable_row_stride(w_, 2)
                                         for h, w_ in shapes])[:-1]))]]
        assert sum(h * 16 * separable_row_stride(w_, 2) * 2 for h, w_ in shapes) == smem
    assert len(separable_plan(eval_shapes, 16, 4)) == 2      # f32 takes two passes


def test_separable_layout_refuses_what_the_kernel_cannot_take():
    """D outside the n8 tiles, an unaligned value, a row wider than shared
    memory and too many bands raise, on any device (checked before launch)."""
    loc, w = torch.zeros(1, 5, 2, 1, 2, 2), torch.zeros(1, 5, 2, 1, 2)
    check = msdeform._check_separable_layout
    for D in (4, 6, 12, 64):
        with pytest.raises(ValueError, match="D must be 8, 16 or 32"):
            check(torch.zeros(1, 6, 2, D), [(2, 3)], loc, w)
    value = torch.zeros(6 * 2 * 8 + 1)[1:].reshape(1, 6, 2, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check(value, [(2, 3)], loc, w)
    with pytest.raises(ValueError, match="shared"):
        separable_plan([(2, 2000)], 32, 4)
    with pytest.raises(ValueError, match="passes"):
        separable_plan([(400, 400)], 32, 4)
    assert len(check(torch.zeros(1, 6, 2, 16), [(2, 3)], loc, w)) == 1
