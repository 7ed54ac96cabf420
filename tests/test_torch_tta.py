"""The test-time augmentor against the JAX package's ``TestAugmentor``: 4, 8
and 16 variants x mean, min and max blends on 2D batches (16 folds to 8 on
2D) and on volumes (16 adds the z-flip), with a forward that is not
flip-equivariant; building from INFERENCE.AUG_MODE/AUG_NUM; output naming;
and the trainer building it in test mode only.  Tolerance: min and max are
exact; mean is within 1 ulp-scale (rtol 1e-6) of numpy's f32 mean."""

import numpy as np
import pytest
import torch

from pctrans_tpu.config import load_cfg as jax_load_cfg
from pctrans_tpu.data.tta import TestAugmentor as JaxTestAugmentor
from pctrans_torch import config
from pctrans_torch.data.tta import TestAugmentor

torch.set_num_threads(1)

W = np.random.RandomState(0).randn(3, 2).astype(np.float32)


def _forward_np(x):
    """[B, (D,) H, W, C] -> [B, 2, (D,) H, W]: a per-pixel mix of the channels
    plus a ramp that breaks the flip symmetry."""
    y = np.moveaxis(x @ W, -1, 1)
    return y + np.linspace(0, 1, y.shape[-1], dtype=np.float32)


def _forward_torch(x):
    y = torch.movedim(x @ torch.from_numpy(W), -1, 1)
    return y + torch.linspace(0, 1, y.shape[-1])


@pytest.mark.parametrize("mode", ["mean", "min", "max"])
@pytest.mark.parametrize("num_aug", [4, 8, 16])
@pytest.mark.parametrize("volumetric", [False, True])
def test_blend_equals_jax(num_aug, mode, volumetric):
    rng = np.random.RandomState(num_aug)
    shape = (2, 3, 6, 6, 3) if volumetric else (2, 6, 6, 3)    # square: transposes
    images = rng.randn(*shape).astype(np.float32)
    ref = JaxTestAugmentor(mode, num_aug)(_forward_np, images)
    ours = TestAugmentor(mode, num_aug)(_forward_torch, torch.from_numpy(images))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6 if mode == "mean" else 0,
                               atol=1e-6 if mode == "mean" else 0)
    n = len(TestAugmentor(mode, num_aug)._variants(volumetric))
    assert n == len(JaxTestAugmentor(mode, num_aug)._variants(volumetric))
    assert n == (16 if num_aug == 16 and volumetric else min(num_aug, 8))


@pytest.mark.parametrize("aug", [(None, None), ("min", 8), ("max", 16)])
def test_build_from_cfg_and_names_equal_jax(aug):
    opts = ["INFERENCE.AUG_MODE", str(aug[0]), "INFERENCE.AUG_NUM", str(aug[1])]
    ours = TestAugmentor.build_from_cfg(config.load_cfg(opts=opts))
    ref = JaxTestAugmentor.build_from_cfg(jax_load_cfg(opts=opts))
    assert (ours.mode, ours.num_aug) == (ref.mode, ref.num_aug)
    for name in ("result.h5", "result"):
        assert ours.update_name(name) == ref.update_name(name)


def test_bad_settings_raise():
    with pytest.raises(ValueError):
        TestAugmentor("median")
    with pytest.raises(ValueError):
        TestAugmentor("mean", 6)


def test_trainer_builds_it_in_test_mode_only(tmp_path):
    from pctrans_torch.engine.trainer import Trainer
    from test_torch_trainer import tiny_opts

    opts = tiny_opts(tmp_path) + ["INFERENCE.AUG_MODE", "max", "INFERENCE.AUG_NUM", "8"]
    tester = Trainer(config.load_cfg(opts=opts), mode="test", device="cpu")
    assert (tester.tta.mode, tester.tta.num_aug) == ("max", 8)
    assert Trainer(config.load_cfg(opts=tiny_opts(tmp_path)), mode="test",
                   device="cpu").tta is None
