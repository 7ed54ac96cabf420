"""The trainer under the settings beyond the published recipes, on the CPU:
``scripts/main_torch.py`` with the reference estimator, WarmupCosineLR,
gradient clipping, SWA and ``DATASET.TRANSFER_UINT8`` (the keys of
``chip_smoke.py``'s phase 8c) on the tiny config of
``tests/test_torch_trainer.py``; the SWA checkpoint's BatchNorm refresh
against the JAX trainer's ``_refresh_batch_stats``; the uint8 transfer and
its dequantization against the JAX trainer's and train step's.

Tolerances: logged rates at rel 1e-6 (the JAX schedule is f32); BatchNorm
statistics at ``tests/test_torch_train_step.py``'s STATS_RTOL of each
statistic's largest entry (f32 forwards in both packages); the uint8
batch and its dequantization bit-equal.
"""

import json
import math
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu import config as jax_config
from pctrans_tpu.engine.solver import build_lr_schedule
from pctrans_tpu.engine.state import TrainState
from pctrans_tpu.engine.trainer import Trainer as JaxTrainer
from pctrans_tpu.models import ModelConfig as JaxConfig
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_torch import config
from pctrans_torch.config import ModelConfig
from pctrans_torch.engine.swa import refresh_batch_stats
from pctrans_torch.engine.train_step import widen_images
from pctrans_torch.engine.trainer import Trainer, uint8_transfer
from pctrans_torch.models import PCTransModel
from pctrans_torch.weights import load_flax_variables, torch_key
from pctrans_torch.weights import _flatten
from test_torch_slice import _randomize
from test_torch_train_step import HW, STATS_RTOL, TINY, _batch
from test_torch_trainer import N_ITERS, tiny_opts

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import eval_torch  # noqa: E402
import main_torch  # noqa: E402

torch.set_num_threads(1)

# chip_smoke.py's phase 8c: the reference estimator and the other SOLVER
# settings, with BatchNorm heads so that the SWA refresh has statistics
SETTINGS = ["MODEL.MASK_FORMER.TPU_RECIPE.POINT_SELECT", "exact",
            "MODEL.MASK_FORMER.TPU_RECIPE.CANDIDATE_RATIO", "3.0",
            "MODEL.MASK_FORMER.TPU_RECIPE.EXACT_TARGETS", "True",
            "MODEL.MASK_FORMER.TPU_RECIPE.SAMPLE_DTYPE", "float32",
            "MODEL.MASK_FORMER.TPU_RECIPE.UPSAMPLE2X", "True",
            "SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR",
            "SOLVER.WARMUP_ITERS", "2",
            "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
            "SOLVER.SWA.ENABLED", "True", "SOLVER.SWA.START_ITER", "2",
            "SOLVER.SWA.MERGE_ITER", "1", "SOLVER.SWA.BN_UPDATE_ITER", "2",
            "DATASET.TRANSFER_UINT8", "True", "MODEL.SEM_SEG_HEAD.NORM", "SyncBN"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("settings")
    opts = tiny_opts(tmp) + SETTINGS
    trainer = main_torch.main(["--device", "cpu", "--opts", *opts])
    return types.SimpleNamespace(tmp=tmp, opts=opts, trainer=trainer,
                                 out=Path(trainer.cfg.DATASET.OUTPUT_PATH))


def test_settings_run_writes_the_swa_checkpoint(run):
    saved = sorted(p.name for p in run.out.glob("*.pth.tar"))
    assert saved == ["checkpoint_000002.pth.tar", "checkpoint_000004.pth.tar",
                     "checkpoint_best.pth.tar", "checkpoint_swa.pth.tar"]
    swa = torch.load(run.out / "checkpoint_swa.pth.tar", weights_only=True)
    last = torch.load(run.out / "checkpoint_000004.pth.tar", weights_only=True)
    assert swa["iteration"] == last["iteration"] == N_ITERS
    # the SWA weights differ from the last ones; the live model kept its own
    live = run.trainer.model.state_dict()
    differ = [k for k in last["model"] if not torch.equal(swa["model"][k], last["model"][k])]
    assert any("running_" in k for k in differ) and any("weight" in k for k in differ)
    for k, v in last["model"].items():
        assert torch.equal(live[k], v), k


def test_settings_run_logs_the_schedule_rates(run):
    records = [json.loads(l) for l in (run.out / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "eval" not in r]
    assert [r["iter"] for r in train] == list(range(N_ITERS))
    assert all(math.isfinite(v) for r in train for v in r.values())
    sched = build_lr_schedule(jax_config.load_cfg(opts=run.opts))
    rates = [r["lr"] for r in train]
    np.testing.assert_allclose(rates, [float(sched(i)) for i in range(N_ITERS)],
                               rtol=1e-6, atol=1e-13)
    # warmup, cosine, then the SWA rate from SWA.START_ITER 2
    assert rates[0] < rates[1] and rates[2] == rates[3] == pytest.approx(
        0.05 * run.trainer.solver.base_lr)


def test_eval_torch_scores_the_swa_checkpoint(run):
    records = eval_torch.main(["--device", "cpu", "--checkpoint",
                               str(run.out / "checkpoint_swa.pth.tar"), "--opts", *run.opts])
    assert [r["iter"] for r in records] == [N_ITERS]
    assert all(math.isfinite(v) for v in records[0].values())
    log = (run.tmp / "test" / "logging.txt").read_text().splitlines()
    assert "checkpoint_swa.pth.tar" in log


def test_refresh_batch_stats_matches_jax():
    """Two train-mode forwards under the same (SWA) weights: the running
    statistics after each flax momentum-0.9 update, against the JAX
    trainer's ``_refresh_batch_stats``."""
    kw = dict(TINY, head_norm="SyncBN")
    jcfg = JaxConfig(**kw)
    variables = jax.jit(JaxModel(config=jcfg, train=True).init)(
        jax.random.key(0), jnp.zeros((1, *HW, 3)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c,
                               np.random.RandomState(4))
                 for c, t in variables.items()}
    batches = [_batch(5), _batch(6)]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       frozen=variables.get("frozen", {}),
                       batch_stats=variables["batch_stats"], opt_state=None)
    fake = types.SimpleNamespace(model_config=jcfg, train_loader=iter(batches))
    ref = JaxTrainer._refresh_batch_stats(fake, state, 2).batch_stats
    model = PCTransModel(ModelConfig(**kw))
    load_flax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    refresh_batch_stats(model, iter(batches), 2)
    ours = model.state_dict()
    stats = list(_flatten(jax.tree_util.tree_map(np.asarray, dict(ref))))
    assert stats
    for path, want in stats:
        key = torch_key("batch_stats", path, variables["params"])
        assert not torch.equal(ours[key], before[key]), key
        np.testing.assert_allclose(ours[key].numpy(), want, rtol=STATS_RTOL,
                                   atol=STATS_RTOL * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("input_range", [(0.0, 1.0), (-1.0, 2.0)])
def test_uint8_transfer_and_dequantization_equal_jax(tmp_path, input_range):
    """One iteration of the JAX trainer under TRANSFER_UINT8: the batch it
    sends equals the port's ``uint8_transfer`` of the same loader batch,
    and the port's dequantization equals the JAX train step's expression
    (``state.py:80-82``) under jit."""
    opts = tiny_opts(tmp_path) + ["DATASET.TRANSFER_UINT8", "True",
                                  "DATASET.TRANSFER_UINT8_RANGE", f"[{input_range[0]}, "
                                  f"{input_range[1]}]", "SOLVER.ITERATION_TOTAL", "1",
                                  "SOLVER.ITERATION_VAL", "0"]
    jtrainer = JaxTrainer(jax_config.load_cfg(opts=opts), mode="train")
    raw, sent = [], []
    loader = jtrainer.train_loader

    def recording_loader():
        for batch in loader:
            raw.append(batch)
            yield batch

    def recording_step(state, batch, rng):
        sent.append(jax.tree_util.tree_map(np.asarray, batch))
        return state, {"loss": jnp.zeros(())}

    jtrainer.train_loader = recording_loader()
    jtrainer._train_step = recording_step
    jtrainer.train()
    ours = uint8_transfer(raw[0], input_range)
    for k in ("image", "label"):
        assert ours[k].dtype == sent[0][k].dtype == np.uint8, k
        np.testing.assert_array_equal(ours[k], sent[0][k], err_msg=k)
    lo, hi = input_range
    ref = jax.jit(lambda u8: u8.astype(jnp.float32) * ((hi - lo) / 255.0) + lo)(
        jnp.asarray(sent[0]["image"]))
    widened = widen_images(torch.from_numpy(ours["image"]), input_range)
    assert widened.dtype == torch.float32
    np.testing.assert_array_equal(widened.numpy(), np.asarray(ref))


def test_uint8_transfer_refuses_wide_labels():
    batch = {"image": np.zeros((1, 4, 4, 3), np.float32),
             "label": np.full((1, 4, 4), 300, np.int32)}
    with pytest.raises(ValueError, match="WIDE_LABELS"):
        uint8_transfer(batch, (0.0, 1.0))
    assert uint8_transfer(batch, (0.0, 1.0), wide_labels=True)["label"].dtype == np.int32


def test_trainer_builds_every_solver_setting(tmp_path):
    """No setting the JAX solver accepts raises in the port's Trainer."""
    for extra in (["SOLVER.NAME", "SGD", "SOLVER.LR_SCHEDULER_NAME", "OneCycle"],
                  ["SOLVER.NAME", "Adam", "SOLVER.LR_SCHEDULER_NAME", "ReduceLROnPlateau"],
                  ["SOLVER.LR_SCHEDULER_NAME", "WarmupMultiStepLR",
                   "SOLVER.WARMUP_METHOD", "constant", "SOLVER.WEIGHT_DECAY_NORM", "0.01",
                   "SOLVER.WEIGHT_DECAY_BIAS", "0.01", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                   "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "value"]):
        cfg = config.load_cfg(opts=tiny_opts(tmp_path) + extra)
        trainer = Trainer(cfg, mode="train", device="cpu")
        trainer.train_loader.close()
        trainer._train_data.close()
