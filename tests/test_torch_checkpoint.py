"""Checkpoints of the port: strict round trip and resume (step, AdamW
moments, LR against the JAX schedule), the partial restore, the sweep's
listing, and the detectron2 R-50 pickle reader against the JAX package's."""

from pathlib import Path

import numpy as np
import pytest
import torch

from pctrans_tpu import config as jax_config
from pctrans_tpu.engine.solver import build_lr_schedule
from pctrans_tpu.models.resnet import convert_d2_r50_pickle as jax_convert
from pctrans_torch import config
from pctrans_torch.engine import checkpoint as ckpt
from pctrans_torch.engine.trainer import Trainer
from pctrans_torch.models.resnet import ResNet, convert_d2_r50_pickle
from pctrans_torch.weights import _flatten, _to_torch, torch_key
from test_torch_trainer import tiny_opts
from test_weights import make_fake_d2_r50, make_fake_zoo_r50

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny Trainer after 2 iterations, with checkpoint_000002."""
    tmp = tmp_path_factory.mktemp("ckpt")
    opts = tiny_opts(tmp) + ["SOLVER.ITERATION_TOTAL", "2", "SOLVER.ITERATION_VAL", "0"]
    trainer = Trainer(config.load_cfg(opts=opts), mode="train", device="cpu")
    trainer.train()
    return opts, tmp, trainer


def _same_state(a: torch.nn.Module, b: torch.nn.Module):
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_strict_resume_restores_step_moments_and_lr(trained):
    opts, tmp, trainer = trained
    path = tmp / "out" / "checkpoint_000002.pth.tar"
    assert ckpt.latest_checkpoint(str(tmp / "out")) == str(path)
    resumed = Trainer(config.load_cfg(opts=opts), mode="train",
                      checkpoint=str(path), device="cpu")
    assert resumed.start_iter == 2
    _same_state(trainer.model, resumed.model)
    ours, ref = resumed.optimizer.state_dict(), trainer.optimizer.state_dict()
    assert ours["state"].keys() == ref["state"].keys() and len(ours["state"]) > 100
    for i, s in ref["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(ours["state"][i][k], s[k], rtol=0, atol=0)
    assert resumed.scheduler.last_epoch == 2
    schedule = build_lr_schedule(jax_config.load_cfg(opts=opts))
    for group in resumed.optimizer.param_groups:
        np.testing.assert_allclose(group["lr"], float(schedule(2)), rtol=1e-6)

    restart = Trainer(config.load_cfg(opts=opts + ["SOLVER.ITERATION_RESTART", "True",
                                                   "MODEL.PRE_MODEL_ITER", "1"]),
                      mode="train", checkpoint=str(path), device="cpu")
    assert restart.start_iter == 1
    _same_state(trainer.model, restart.model)


def test_partial_restore_keeps_init_for_changed_queries(trained, capsys):
    opts, tmp, trainer = trained
    path = tmp / "out" / "checkpoint_000002.pth.tar"
    wider = opts + ["MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "12"]
    fresh = Trainer(config.load_cfg(opts=wider), mode="train", device="cpu")
    part = Trainer(config.load_cfg(opts=wider), mode="train",
                   checkpoint=str(path), device="cpu")
    log = capsys.readouterr().out
    assert "strict restore failed" in log and "shape mismatch" in log
    assert "optimizer state" in log and "not adopted" in log
    assert part.start_iter == 0 and not part.optimizer.state
    changed = {"predictor.query_feat", "predictor.query_embed"}
    src = trainer.model.state_dict()
    for k, v in part.model.state_dict().items():
        ref = fresh.model.state_dict()[k] if k in changed else src[k]
        torch.testing.assert_close(v, ref, rtol=0, atol=0, msg=k)


def test_partial_restore_logs_an_optimizer_that_does_not_fit(trained):
    opts, tmp, trainer = trained
    model = Trainer(config.load_cfg(opts=opts), mode="test", device="cpu").model
    one_group = torch.optim.AdamW(model.parameters())
    lines = []
    step = ckpt.restore_partial(str(tmp / "out" / "checkpoint_000002.pth.tar"), model,
                                one_group, log=lines.append)
    assert step == 0 and not one_group.state
    assert any("optimizer state" in l and "does not fit" in l for l in lines)
    _same_state(trainer.model, model)


def test_listing_orders_by_iteration_past_six_digits(tmp_path):
    for it in (2, 10, 1_000_000, 999_999):
        (tmp_path / (ckpt._FMT % it)).touch()
    (tmp_path / "checkpoint_best.pth.tar").touch()
    (tmp_path / "checkpoint_000003.pth.tar.12.tmp").touch()
    found = ckpt.list_checkpoints(str(tmp_path))
    assert [ckpt.checkpoint_iteration(p) for p in found] == [2, 10, 999_999, 1_000_000]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint_1000000.pth.tar")
    assert ckpt.checkpoint_iteration("checkpoint_best.pth.tar") == -1
    assert ckpt.list_checkpoints(str(tmp_path / "none")) == []


@pytest.mark.parametrize("writer,bgr", [(make_fake_d2_r50, True), (make_fake_zoo_r50, True),
                                        (make_fake_zoo_r50, False)])
def test_r50_pickle_equals_the_jax_conversion(tmp_path, writer, bgr):
    path = tmp_path / "r50.pkl"
    writer(np.random.RandomState(0), str(path))
    params, frozen = jax_convert(str(path), conv1_bgr_to_rgb=bgr)
    tree = {"params": {"backbone": params}, "frozen": {"backbone": frozen}}
    ref = {}
    for col, t in tree.items():
        for p, a in _flatten(t):
            key = torch_key(col, p, tree["params"])
            ref[key[len("backbone."):]] = _to_torch(np.asarray(a), p[-1])
    ours = convert_d2_r50_pickle(str(path), conv1_bgr_to_rgb=bgr)
    assert set(ours) == set(ref) == set(ResNet(50).state_dict())
    for k, v in ref.items():
        torch.testing.assert_close(ours[k], v, rtol=0, atol=0, msg=k)


def test_trainer_loads_model_weights(tmp_path):
    path = tmp_path / "r50.pkl"
    make_fake_d2_r50(np.random.RandomState(1), str(path))
    opts = tiny_opts(tmp_path) + ["MODEL.RESNETS.DEPTH", "50", "MODEL.WEIGHTS", str(path)]
    trainer = Trainer(config.load_cfg(opts=opts), mode="test", device="cpu")
    for k, v in convert_d2_r50_pickle(str(path)).items():
        torch.testing.assert_close(trainer.model.backbone.state_dict()[k], v,
                                   rtol=0, atol=0, msg=k)
