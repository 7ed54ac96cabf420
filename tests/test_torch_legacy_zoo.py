"""The port's FPN3D (ResNet3D, RepVGG3D, BotNet3D, EfficientNet3D
backbones), unet_residual_3d and Discriminator3D against the JAX
package's (``pctrans_tpu/models/legacy``) at tiny widths, through
``torch_legacy_parity.check_pair``: flax variables from ``jax.eval_shape``
and a numpy fill (BatchNorm statistics and affine randomised), loaded by
``load_flax_legacy_variables``; eager JAX forwards and gradients; forward
rel-Fro 1e-5, gradients 1e-4, in f32.
"""

import jax
import numpy as np
import pytest
import torch

from pctrans_tpu.models.legacy import FPN3D as JaxFPN3D
from pctrans_tpu.models.legacy import Discriminator3D as JaxDiscriminator3D
from pctrans_tpu.models.legacy import UNetResidual3D as JaxUNetResidual3D
from pctrans_tpu.models.legacy import repvgg_convert as jax_repvgg_convert
from pctrans_tpu.models.legacy.efficientnet import InvertedResidual3D as JaxInvertedResidual3D
from pctrans_torch.models.layers import BatchNorm
from pctrans_torch.models.legacy import (FPN3D, BotAttention, Discriminator3D, RepVGGBlock3D,
                                         UNetResidual3D, init_legacy_weights, repvgg_convert)
from pctrans_torch.models.legacy.efficientnet import InvertedResidual3D
from pctrans_torch.weights import load_flax_legacy_variables
from torch_legacy_parity import FWD_REL_FRO, check_pair, flax_variables, rel_fro
from torch_legacy_parity import input_array as _input

torch.set_num_threads(1)

FILTERS = (4, 6, 8)
ISOTROPY = (False, True, True)
BLOCKS = (1, 2)
FPN_INPUT = (2, 2, 5, 10, 10)        # odd z, h, w: ceil convs beside floor pools


# ---------------------------------------------------------------- FPN3D
def _fpn(backbone, train, **kw):
    kw = dict(dict(backbone_type=backbone, out_channel=2, filters=FILTERS, blocks=BLOCKS,
                   isotropy=ISOTROPY), **kw)
    return (JaxFPN3D(train=train, **kw),
            FPN3D(in_channel=FPN_INPUT[1], input_size=FPN_INPUT[2:], **kw))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("backbone", ["resnet", "repvgg", "botnet", "efficientnet"])
def test_fpn3d_matches_flax(backbone, train):
    """Each backbone under the FPN: the forward in both modes, the running
    statistics and the parameter gradients in train mode."""
    jmodel, model = _fpn(backbone, train)
    x = _input(FPN_INPUT)
    check_pair(jmodel, flax_variables(jmodel, x), model, x, train, grads=train)


def test_fpn3d_residual_se_and_groupnorm_match_flax():
    jmodel, model = _fpn("resnet", True, block_type="residual_se", norm_mode="gn",
                         pad_mode="zeros", is_isotropic=True)
    x = _input(FPN_INPUT)
    check_pair(jmodel, flax_variables(jmodel, x), model, x, True)


# --------------------------------------------------------------- RepVGG
def _repvgg_variables():
    jmodel, model = _fpn("repvgg", False)
    x = _input(FPN_INPUT)
    return jmodel, flax_variables(jmodel, x), model, x


def test_repvgg_deploy_converted_by_jax_equals_the_ports_conversion():
    """JAX's ``repvgg_convert`` on the backbone's flax tree, loaded into the
    port's deploy FPN3D, gives the model the port's own conversion makes
    of the train-mode FPN3D loaded with the same tree: equal weights and,
    in eval mode, equal outputs."""
    _, variables, model, x = _repvgg_variables()
    load_flax_legacy_variables(model, variables)
    ours = repvgg_convert(model.eval())
    backbone = jax_repvgg_convert({"params": variables["params"]["backbone"],
                                   "batch_stats": variables["batch_stats"]["backbone"]})
    deploy_vars = {"params": dict(variables["params"], backbone=backbone["params"]),
                   "batch_stats": {k: v for k, v in variables["batch_stats"].items()
                                   if k != "backbone"}}
    deploy = _fpn("repvgg", False, deploy=True)[1]
    load_flax_legacy_variables(deploy, jax.tree_util.tree_map(np.asarray, deploy_vars))
    assert set(ours.state_dict()) == set(deploy.state_dict())
    for k, v in deploy.state_dict().items():
        assert rel_fro(ours.state_dict()[k].numpy(), v.numpy()) <= FWD_REL_FRO, k
    with torch.no_grad():
        xt = torch.from_numpy(x)
        assert rel_fro(ours(xt).numpy(), deploy.eval()(xt).numpy()) <= FWD_REL_FRO


@pytest.mark.parametrize("in_ch,strides,isotropic", [(6, (1, 1, 1), False),
                                                     (6, (1, 1, 1), True),
                                                     (4, (1, 2, 2), False)])
def test_repvgg_deploy_equals_train_mode_eval(in_ch, strides, isotropic):
    """The fused block equals the three branches under the running statistics
    (``tests/test_legacy_models.py::TestRepVGGDeploy``'s check), with and
    without the identity branch."""
    gen = torch.Generator().manual_seed(0)
    block = RepVGGBlock3D(in_ch, 6, strides, isotropic, "replicate", "elu")
    init_legacy_weights(block, gen)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, BatchNorm):
                for t in (m.weight, m.running_var):
                    t.uniform_(0.5, 1.5, generator=gen)
                for t in (m.bias, m.running_mean):
                    t.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(2, in_ch, 3, 9, 9, generator=gen)
    deploy = repvgg_convert(block.eval())
    assert deploy.deploy and [n for n, _ in deploy.named_children()] == ["rbr_reparam"]
    with torch.no_grad():
        assert rel_fro(deploy(x).numpy(), block(x).numpy()) <= FWD_REL_FRO


# --------------------------------------------------------------- BotNet
def test_botnet_position_tables_follow_the_input_size():
    """Block 0 attends at the stage's input size, blocks 1-2 at half of it
    (the pool follows the attention); a map of another size raises."""
    model = _fpn("botnet", False)[1]
    sizes = [tuple(getattr(model.backbone, f"layer4_block{b}").attn.pos_emb_h.shape)
             + tuple(getattr(model.backbone, f"layer4_block{b}").attn.pos_emb_w.shape)
             for b in range(3)]
    assert sizes == [(5, 32, 5, 32), (2, 32, 2, 32), (2, 32, 2, 32)]
    with pytest.raises(ValueError, match="input_size"):
        model(torch.zeros(1, FPN_INPUT[1], 5, 12, 12))


def test_init_draws_the_position_tables_from_the_generator():
    model = _fpn("botnet", False)[1]
    draws = []
    for seed in (0, 0, 1):
        init_legacy_weights(model, torch.Generator().manual_seed(seed))
        draws.append(torch.cat([m.pos_emb_h.flatten() for m in model.modules()
                                if isinstance(m, BotAttention)]).clone())
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    big = BotAttention(8, (64, 64), dim_head=16)
    init_legacy_weights(big, torch.Generator().manual_seed(0))
    assert abs(float(big.pos_emb_h.detach().std()) - 16 ** -0.5) < 0.02


def test_bridge_rejects_missing_and_extra_keys_on_botnet():
    jmodel, model = _fpn("botnet", False)
    variables = flax_variables(jmodel, _input(FPN_INPUT))
    attn = variables["params"]["backbone"]["layer4_block1"]["attn"]
    missing = {"params": jax.tree_util.tree_map(lambda a: a, variables["params"]),
               "batch_stats": variables["batch_stats"]}
    del missing["params"]["backbone"]["layer4_block1"]["attn"]["pos_emb_w"]
    with pytest.raises(KeyError, match="layer4_block1.attn.pos_emb_w"):
        load_flax_legacy_variables(model, missing)
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["backbone"]["layer4_block1"]["attn"]["pos_emb_z"] = attn["pos_emb_h"]
    with pytest.raises(KeyError, match="pos_emb_z"):
        load_flax_legacy_variables(model, extra)


# --------------------------------------------------------- EfficientNet
@pytest.mark.parametrize("strides,in_ch,isotropic", [(2, 4, True), ((1, 2, 2), 4, False),
                                                     (1, 4, False)])
def test_inverted_residual_strided_skip_on_an_odd_size(strides, in_ch, isotropic):
    """A strided skip average-pools (floor) and edge-pads to the conv's
    (ceil) size; a stride of 1 between equal widths keeps the identity."""
    jblock = JaxInvertedResidual3D(6 if strides != 1 else in_ch, strides=strides,
                                   isotropic=isotropic, train=True)
    block = InvertedResidual3D(in_ch, 6 if strides != 1 else in_ch, strides=strides,
                               isotropic=isotropic)
    x = _input((2, in_ch, 5, 7, 9))
    check_pair(jblock, flax_variables(jblock, x), block, x, True, grads=True)


# ------------------------------------------------------ unet_residual_3d
@pytest.mark.parametrize("do_embedding,head_depth", [(True, 1), (False, 1), (False, 2)])
def test_unet_residual_3d_matches_flax(do_embedding, head_depth):
    kw = dict(out_channel=2, filters=(4, 5, 6, 7), do_embedding=do_embedding,
              head_depth=head_depth)
    shape = (2, 1, 3, 16, 16) if do_embedding else (2, 4, 3, 16, 16)
    jmodel = JaxUNetResidual3D(train=True, **kw)
    model = UNetResidual3D(in_channel=shape[1], **kw)
    x = _input(shape)
    check_pair(jmodel, flax_variables(jmodel, x), model, x, True, grads=True)


# -------------------------------------------------------- Discriminator
@pytest.mark.parametrize("norm_mode,is_isotropic", [("in", False), ("bn", False),
                                                    ("bn", True), ("none", False)])
def test_discriminator_matches_flax(norm_mode, is_isotropic):
    """The affine-free instance norm has no parameters; anisotropic stages
    never stride z."""
    kw = dict(filters=(4, 4, 6, 6, 8), norm_mode=norm_mode, is_isotropic=is_isotropic)
    jmodel = JaxDiscriminator3D(train=True, **kw)
    model = Discriminator3D(in_channel=3, **kw)
    x = _input((2, 3, 8, 32, 32))
    variables = flax_variables(jmodel, x)
    check_pair(jmodel, variables, model, x, True, grads=True)
    depths = [getattr(model, f"layer{n}_conv").stride[0] for n in range(5)]
    assert depths == ([2, 2, 2, 2, 1] if is_isotropic else [1, 1, 1, 2, 1])


def test_step_precision_reads_the_f32_step_against_f64_on_the_cpu(capsys):
    """``python3 -m pctrans_torch.models.legacy.step_precision --device cpu``:
    the f64 reference, then the f32 step's loss and gradient-norm distances
    from it (the norm summed in f64 and as the step summed it) and its
    farthest parameter; on a well-conditioned U-Net all are small."""
    import re

    from pctrans_torch.models.legacy import step_precision

    assert step_precision.main(["unet_2d", "--batch", "3", "--size", "32",
                                "--device", "cpu"]) == 0
    head, row = capsys.readouterr().out.strip().splitlines()
    assert head.startswith("unet_2d [3, 1, 32, 32]: f64 CPU loss ")
    m = re.fullmatch(r"  f32 CPU: loss (\S+), grad norm (\S+) \(summed in the step's dtype "
                     r"(\S+)\), farthest (\S+) (\S+)", row)
    assert m is not None, row
    assert max(float(m[i]) for i in (1, 2, 3)) < 1e-6 and float(m[5]) < 1e-4
