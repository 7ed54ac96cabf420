"""The analytic FLOP count against ``FlopCounterMode``'s count of the
program's own forward, and the kernels' byte and operation counts and the
bounds made from them against ``chip_smoke.py``'s on the same inputs.

``FlopCounterMode`` counts aten's convolutions, dense layers and batched
products.  It leaves out the deformable sampling (gathers and elementwise
work, no aten FLOPs; ``flops.sampling_flops`` adds it) and, on the card,
the render's dynamic 1x1 convolutions (K3 is no aten op there; on the CPU
the port renders with its einsum twin, which aten counts, and so does the
reference the count runs)."""

import math
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import bench, probes, timing
from portbench.counts import flops
from tiny import tiny_config

sys.path.insert(0, str(bench.REPO))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("hw", [(64, 64), (70, 90)])
def test_forward_count_equals_the_programs_aten_count(hw):
    from pctrans_torch.models import PCTransModel
    from pctrans_torch.models.pctrans import ModelConfig

    sizes = tiny_config("cvppp")["model"]
    model = PCTransModel(ModelConfig(**{**{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in sizes.items()}, "dtype": "float32"}),
                         generator=torch.Generator().manual_seed(0)).eval()
    model.requires_grad_(False)
    with FlopCounterMode(display=False) as counter:
        model(torch.rand(1, hw[0], hw[1], 3) * 255)
    assert flops.aten_flops(sizes, hw) == counter.get_total_flops()


def test_sampling_term_counts_every_sample():
    sizes = bench.read_json(bench.HERE / "configs" / "cvppp.json")["model"]
    assert flops.level_sizes((530, 500)) == chip_smoke.EVAL_SHAPES[::-1]
    assert flops.level_sizes((448, 448)) == chip_smoke.TRAIN_SHAPES[::-1]
    lq = sum(h * w for h, w in chip_smoke.EVAL_SHAPES)
    assert flops.sampling_flops(sizes, (530, 500)) == 6 * lq * 8 * 3 * 4 * (10 * 16 + 10)


def test_msdeform_counts_equal_chip_smoke():
    g = torch.Generator().manual_seed(0)
    value, shapes, loc, w = chip_smoke.msdeform_inputs("cpu", g, batch=2,
                                                        shapes=chip_smoke.TRAIN_SHAPES)
    n_bytes, f = timing.msdeform_work(value, shapes, loc, w)
    assert (n_bytes, int(f)) == chip_smoke.msdeform_work(value, shapes, loc, w)
    grad = torch.randn(value.shape[0], loc.shape[1], value.shape[2] * value.shape[3],
                       generator=g)
    n_bytes, f = timing.msdeform_backward_work(value, shapes, loc, w, grad)
    assert (n_bytes, int(f)) == chip_smoke.msdeform_backward_work(value, shapes, loc, w, grad)


def test_render_and_resize_counts_equal_chip_smoke():
    g = torch.Generator().manual_seed(0)
    args = chip_smoke.render_inputs("cpu", g)
    feats, inst_xy, w1, w2, w3, b1, b2, b3, (Hm, Wm) = args[:9]
    out = torch.zeros(w1.shape[0], w1.shape[1], Hm * Wm)
    n_bytes, f = timing.render_work(*args[:9], out)
    B, Q, ch, Cm = chip_smoke.BATCH, w1.shape[1], w1.shape[2], feats.shape[2]
    assert f == 2 * B * Q * Hm * Wm * (ch * (Cm + 2) + ch * ch + ch)
    assert n_bytes == chip_smoke.nbytes(feats, inst_xy, w1, w2, w3, b1, b2, b3, out)
    x = torch.randn(2, 50, 133, 125)
    out = torch.zeros(2, 50, 530, 500, dtype=torch.uint8)
    assert timing.resize_binarize_work(x, out) == (chip_smoke.nbytes(x, out), 10 * out.numel())
    ms, by = timing.bound_ms(*timing.resize_binarize_work(x, out))
    assert by == "bytes" and math.isclose(ms, (x.numel() * 4 + out.numel()) / 3.35e12 * 1e3)


def _bound_cases(kernel: str):
    """(the wrapper's arguments, its output, the range's work function,
    chip_smoke.py's bound in ms) for one kernel on chip_smoke's inputs."""
    g = torch.Generator().manual_seed(1)
    if kernel in ("k1", "k2"):
        value, shapes, loc, w = chip_smoke.msdeform_inputs("cpu", g, batch=2,
                                                            shapes=chip_smoke.TRAIN_SHAPES)
        vb = value.bfloat16()
        if kernel == "k1":
            return ((vb, shapes, loc, w), None,
                    lambda a, out: timing.msdeform_work(*a[:4]),
                    chip_smoke.bound("K1", *chip_smoke.msdeform_work(vb, shapes, loc, w),
                                     1.0)["bound_ms"])
        gb = torch.randn(2, loc.shape[1], value.shape[2] * value.shape[3],
                         generator=g).bfloat16()
        return ((vb, shapes, loc, w, gb), None,
                lambda a, out: timing.msdeform_backward_work(*a[:5]),
                chip_smoke.bound("K2", *chip_smoke.msdeform_backward_work(
                    vb, shapes, loc, w, gb), 1.0)["bound_ms"])
    if kernel == "k3":
        args = chip_smoke.render_inputs("cpu", g)
        feats, inst_xy, w1, w2, w3, b1, b2, b3, (Hm, Wm) = args[:9]
        out = torch.zeros(w1.shape[0], w1.shape[1], Hm * Wm)
        B, Q, ch, Cm = chip_smoke.BATCH, w1.shape[1], w1.shape[2], feats.shape[2]
        flops = 2 * B * Q * Hm * Wm * (ch * (Cm + 2) + ch * ch + ch)
        n_bytes = chip_smoke.nbytes(feats, inst_xy, w1, w2, w3, b1, b2, b3, out)
        return (args, out, lambda a, o: timing.render_work(*a[:9], o),
                chip_smoke.bound("K3 (3xTF32, tensor cores)", n_bytes, 3 * flops, 1.0,
                                 chip_smoke.PEAK_TF32_FLOP_PER_S, "TF32")["bound_ms"])
    _, B, K, hw, _ = chip_smoke.K4_CASES[-1]
    x = torch.randn(B, K, *chip_smoke.stage_sizes(hw)[0], generator=g)
    out = torch.zeros(B, K, *hw, dtype=torch.uint8)
    return ((x,), out, lambda a, o: timing.resize_binarize_work(a[0], o),
            chip_smoke.bound("K4", chip_smoke.nbytes(x, out), 10 * out.numel(),
                             1.0)["bound_ms"])


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
def test_range_bound_equals_chip_smokes(kernel):
    """A range's bound, summed over calls by the probe that wraps the
    kernel's call, is chip_smoke.py's bound of each call: K3's 3xTF32
    included."""
    args, out, work, want_ms = _bound_cases(kernel)
    probe = probes.Probes(timing.Clock())
    wrapped = probe._kernel(f"portbench.{kernel}", work)(lambda *a: out)
    probe.counting = True
    for _ in range(2):
        wrapped(*args)
    got = probe.kernel_bounds()[f"portbench.{kernel}"]
    assert got["calls"] == 2
    assert math.isclose(got["bound_s"] * 1e3, 2 * want_ms, rel_tol=1e-12)
