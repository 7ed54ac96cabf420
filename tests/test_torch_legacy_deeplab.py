"""The port's DeepLabV3 a/b/c over ResNet2D (``pctrans_torch/models/legacy/
deeplab.py``) against the JAX package's at ResNet depth (1, 1, 1, 1) (the
widths are ResNet-50's), and the BatchNorm case its image-pooling branch
meets at batch 1.  Forward rel-Fro 1e-5, gradients 1e-4, in f32
(``torch_legacy_parity``).

The train-mode gradients run at batch 3: at batch 2 the pooled branch's
BatchNorm sees two values per channel and normalises them to +-(1 - d)
with d ~ 2e-3, where both packages' f32 gradients lose ~1/d to
cancellation (pool_conv 1.8e-4 apart, the backbone 6e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from pctrans_tpu.models.legacy import DeepLabV3 as JaxDeepLabV3
from pctrans_tpu.models.legacy.resnet_legacy import ResNet2D as JaxResNet2D
from pctrans_torch.models.layers import BatchNorm
from pctrans_torch.models.legacy import DeepLabV3, ResNet2D
from pctrans_torch.weights import load_flax_legacy_variables
from torch_legacy_parity import check_pair, flax_variables, nchw, nhwc
from torch_legacy_parity import input_array as _input

torch.set_num_threads(1)

DEEPLAB_LAYERS = (1, 1, 1, 1)


@pytest.mark.parametrize("variant,shape,train", [
    ("deeplabv3a", (3, 2, 33, 31), True), ("deeplabv3b", (3, 2, 33, 31), True),
    ("deeplabv3c", (3, 2, 33, 31), True), ("deeplabv3a", (3, 2, 33, 31), False),
    ("deeplabv3b", (1, 2, 32, 32), True)])
def test_deeplab_matches_flax(variant, shape, train):
    """Each head with the aux classifier on an odd size (v3b upsamples 5x4
    to 9x7) in train mode, v3a in eval mode, and v3b at batch 1 in train
    mode, where the image-pooling branch's BatchNorm sees one value per
    channel."""
    kw = dict(name_variant=variant, out_channel=2, aux_out=True,
              backbone_layers=DEEPLAB_LAYERS)
    jmodel = JaxDeepLabV3(train=train, **kw)
    model = DeepLabV3(in_channel=shape[1], **kw)
    x = _input(shape)
    check_pair(jmodel, flax_variables(jmodel, x), model, x, train, grads=train)


def test_resnet2d_elu_stem_pads_zeros_before_the_pool():
    """Under elu the stem's border values are negative: zero padding (JAX's)
    and -inf padding (``max_pool2d(padding=1)``) part there."""
    kw = dict(layers=(1, 1, 1, 1), act_mode="elu")
    jmodel = JaxResNet2D(train=False, low_level_feat=True, aux_out=True, **kw)
    model = ResNet2D(in_channel=1, low_level_feat=True, aux_out=True, **kw)
    x = _input((2, 1, 20, 20)) - 3.0           # a mostly negative stem output
    variables = flax_variables(jmodel, x)
    check_pair(jmodel, variables, model, x, False)
    with torch.no_grad():
        stem = model.act(model.norm0(model.conv1(F.pad(
            torch.from_numpy(x), (3, 3, 3, 3)))))
        zero = F.max_pool2d(F.pad(stem, (1,) * 4), 3, 2)
        ninf = F.max_pool2d(stem, 3, 2, padding=1)
    assert float((stem < 0).float().mean()) > 0.5 and not torch.equal(zero, ninf)


def test_batchnorm_of_one_value_per_channel_is_flax_s():
    """[1, C, 1, 1] in train mode: flax normalises to the bias and updates
    the running statistics with variance 0; ``F.batch_norm`` raises there."""
    x = _input((1, 5, 1, 1))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = flax_variables(jbn, x)
    ref, stats = jbn.apply(variables, jnp.asarray(nhwc(x)), mutable=["batch_stats"])
    bn = BatchNorm(5)
    load_flax_legacy_variables(bn, variables)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bn.train()(xt)
    np.testing.assert_allclose(out.detach().numpy(), nchw(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out.detach().numpy().ravel(),
                               variables["params"]["bias"], rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["batch_stats"]["var"],
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["batch_stats"]["mean"],
                               rtol=1e-6)
    out.sum().backward()
    assert float(xt.grad.abs().max()) == 0.0


