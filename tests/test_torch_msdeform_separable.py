"""K5's plain version (the separable twin), its gradient through the
``pallas`` path and the ``$PCTRANS_MSDA_IMPL`` dispatch, against the JAX
package's ``ms_deform_attn_core_pallas`` (``_level_kernel`` in interpret
mode, as ``tests/test_ops.py`` runs it on the CPU).

Tolerances: f32 on both sides, other summation orders; the forward at
rel-Fro 1e-5, the gradient at rel-Fro 1e-4 (its sums run over every pixel
of a level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.ops.msdeform_pallas import ms_deform_attn_core_pallas
from pctrans_torch.config import ModelConfig
from pctrans_torch.models import PCTransModel
from pctrans_torch.models.pixel_decoder import MSDeformAttn
from pctrans_torch.ops import msdeform
from pctrans_torch.ops.msdeform import (ms_deform_attn, ms_deform_attn_separable,
                                        ms_deform_attn_separable_twin,
                                        ms_deform_attn_twin, resolve_impl)

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


def _torch_grads(value, shapes, locs, attn, g, impl="pallas"):
    prim = [torch.from_numpy(a).requires_grad_() for a in (value, locs, attn)]
    out = ms_deform_attn(prim[0], list(shapes), prim[1], prim[2], impl=impl)
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


def test_pallas_path_gradient_matches_jax_k5_off_the_grid():
    value, locs, attn, g = _inputs(2)
    ref = _jax_vjp(value, SHAPES, locs, attn, g)
    ours = _torch_grads(value, SHAPES, locs, attn, g)
    for name, a, b in zip(("value", "locations", "weights"), ours, ref):
        assert _rel(a, b) <= GRAD_REL, name
    # the 4-corner twin's autograd (K2's plain version) agrees as well
    corner = _torch_grads(value, SHAPES, locs, attn, g, impl="twin")
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


@pytest.mark.parametrize("env,impl,expect", [
    (None, None, "ms_deform_attn_twin"),
    ("auto", None, "ms_deform_attn_twin"),
    ("pallas2", None, "ms_deform_attn_twin"),
    ("pallas", None, "ms_deform_attn_separable_twin"),
    ("pallas", "pallas2", "ms_deform_attn_twin"),       # impl= wins
    ("pallas", "twin", "ms_deform_attn_twin"),
    (None, "pallas", "ms_deform_attn_separable_twin"),
    ("pallas2", "pallas", "ms_deform_attn_separable_twin"),
])
def test_dispatch_reads_the_variable_at_call_time(monkeypatch, env, impl, expect):
    if env is None:
        monkeypatch.delenv("PCTRANS_MSDA_IMPL", raising=False)
    else:
        monkeypatch.setenv("PCTRANS_MSDA_IMPL", env)
    calls = _spy(monkeypatch)
    value, locs, attn, _ = _inputs(5, Lq=9)
    before = (ms_deform_attn.launches, ms_deform_attn_separable.launches)
    out = ms_deform_attn(*(torch.from_numpy(a) for a in (value,)), list(SHAPES),
                         torch.from_numpy(locs), torch.from_numpy(attn), impl=impl)
    assert calls == [expect] and out.shape == (2, 9, 16)
    assert (ms_deform_attn.launches, ms_deform_attn_separable.launches) == before


@pytest.mark.parametrize("env", ["matmul", "separable", "gather", "reference"])
def test_tpu_formulations_are_rejected(monkeypatch, env):
    monkeypatch.setenv("PCTRANS_MSDA_IMPL", env)
    with pytest.raises(ValueError, match="Not to port"):
        resolve_impl(None)
    monkeypatch.delenv("PCTRANS_MSDA_IMPL")
    with pytest.raises(ValueError, match="Not to port"):
        resolve_impl(env)


@pytest.mark.parametrize("env", ["twin", "plain", "kernel"])
def test_the_variable_cannot_select_a_twin(monkeypatch, env):
    monkeypatch.setenv("PCTRANS_MSDA_IMPL", env)
    with pytest.raises(ValueError, match="PCTRANS_MSDA_IMPL"):
        resolve_impl(None)
    assert resolve_impl("twin") == "twin"          # only the argument can


def test_pallas_on_a_non_cpu_device_raises_without_fallback(monkeypatch):
    monkeypatch.setenv("PCTRANS_MSDA_IMPL", "pallas")
    m = "meta"
    with pytest.raises(RuntimeError, match="ms_deform_attn_separable"):
        ms_deform_attn(torch.empty(1, 6, 2, 4, device=m), [(2, 3)],
                       torch.empty(1, 5, 2, 1, 2, 2, device=m),
                       torch.empty(1, 5, 2, 1, 2, device=m))


def test_model_forward_under_pallas_matches_the_default(monkeypatch):
    """The tiny model's forward with PCTRANS_MSDA_IMPL=pallas (the separable
    twin in every encoder layer) against the default (4-corner twin)."""
    cfg = ModelConfig(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10,
                      nheads=4, dim_feedforward=64, enc_layers=2, dec_layers=3,
                      backbone_depth=14, head_norm="GN")
    model = PCTransModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for layer in model.pixel_decoder.modules():
            if isinstance(layer, MSDeformAttn):          # samples off the grid
                layer.sampling_offsets.weight.normal_(0.0, 0.05)
    images = torch.from_numpy(np.random.RandomState(6).randn(2, 48, 40, 3).astype(np.float32))
    calls = _spy(monkeypatch)
    with torch.no_grad():
        monkeypatch.delenv("PCTRANS_MSDA_IMPL", raising=False)
        ref = model(images)["pred_masks"]
        monkeypatch.setenv("PCTRANS_MSDA_IMPL", "pallas")
        out = model(images)["pred_masks"]
    assert calls == ["ms_deform_attn_twin"] * 2 + ["ms_deform_attn_separable_twin"] * 2
    assert _rel(out.numpy(), ref.numpy()) <= 1e-4
