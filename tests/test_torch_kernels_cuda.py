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

from pctrans_torch.ops.msdeform import ms_deform_attn
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


@pytest.mark.parametrize("M,D,Lq,shapes", [
    (8, 16, 37, [(5, 7), (3, 4), (9, 2)]),
    (4, 8, 1, [(6, 5)]),
    (2, 32, 300, [(11, 13), (6, 7)]),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_msdeform_kernel_matches_twin(dev, M, D, Lq, shapes, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(0)
    B, L, P = 2, len(shapes), 3
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, device=dev, generator=g).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, device=dev, generator=g) * 1.4 - 0.2
    w = torch.rand(B, Lq, M, L, P, device=dev, generator=g)
    before = ms_deform_attn.launches
    out = ms_deform_attn(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    ref = ms_deform_attn(value, shapes, loc, w, impl="twin")
    assert out.dtype == dtype and out.shape == (B, Lq, M * D)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("rel_coord", [True, False])
@pytest.mark.parametrize("Q,hw,Cm", [(7, (13, 9), 16), (100, (33, 31), 8),
                                     (5, (4, 6), 4)])
def test_render_kernel_matches_twin(dev, rel_coord, Q, hw, Cm):
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


@pytest.mark.parametrize("shape,size", [
    ((2, 3, 17, 21), (68, 84)),
    ((1, 4, 13, 16), (50, 61)),
    ((2, 2, 40, 30), (13, 11)),      # downsample
])
def test_resize_binarize_kernel_matches_twin(dev, shape, size):
    g = torch.Generator(device=dev).manual_seed(2)
    t = math.log(0.69 / 0.31)
    x = torch.randn(*shape, device=dev, generator=g) * 2.0
    out = resize_bilinear_binarize(x, size, t)
    torch.cuda.synchronize()
    ref = resize_bilinear_binarize(x, size, t, impl="twin")
    logits = resize_bilinear(x, size)
    differ = out != ref
    assert bool(((logits[differ] - t).abs() <= 1e-5).all())


def test_render_kernel_refuses_unaligned_channels(dev):
    """The kernel reads features as float4: Cm % 4 != 0 raises, and a
    feature map at an odd offset is realigned, not misread."""
    B, Q, hw, ch = 1, 3, (4, 5), 8
    z = lambda *s: torch.rand(*s, device=dev)
    with pytest.raises(ValueError, match="Cm % 4"):
        dynamic_mask_render(z(B, 20, 6), z(B, Q, 2), z(B, Q, ch, 8), z(B, Q, ch, ch),
                            z(B, Q, 1, ch), z(B, Q, ch), z(B, Q, ch), z(B, Q, 1),
                            hw, 4, True)
    feats = z(B * 20 * 16 + 1)[1:].reshape(B, 20, 16)
    args = (feats, z(B, Q, 2), z(B, Q, ch, 18), z(B, Q, ch, ch), z(B, Q, 1, ch),
            z(B, Q, ch), z(B, Q, ch), z(B, Q, 1), hw, 4, True)
    out = dynamic_mask_render(*args)
    assert _rel(out, dynamic_mask_render(*args, impl="twin")) <= 1e-5


def test_msdeform_kernel_refuses_grad(dev):
    value = torch.randn(1, 6, 2, 4, device=dev, requires_grad=True)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=dev)
    w = torch.rand(1, 5, 2, 1, 2, device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        ms_deform_attn(value, [(2, 3)], loc, w)
