"""The entry-point slice as a whole: the port's ``Trainer`` on the tiny
config of ``tests/test_trainer.py::tiny_cfg`` (64x64, so that GroupNorm's
1x1 res5 map has more than one value per group), ``synthetic`` data, f32,
from JAX-init weights, against the JAX package's ``make_train_step`` on the
same batches, weights and re-id draws; then the checkpoint sweep of
``scripts/eval_torch.py``; the ``_num_valid`` repair; the CLI without a card;
the BBBC recipe's train, validation (AJI), ``test_bbbc`` and dispatch.

Loss tolerances are ``tests/test_torch_train_step.py``'s (f32, the JAX CPU
path samples ms-deform with the hat-matmul and the port with the 4-corner
twin); the sampling-offset kernel is randomised so that samples leave the
integer pixel grid (ROADMAP.md §C.6).
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu import config as jax_config
from pctrans_tpu.engine.solver import build_optimizer as jax_build_optimizer
from pctrans_tpu.engine.state import TrainState
from pctrans_tpu.engine.state import make_train_step as jax_make_train_step
from pctrans_tpu.losses import build_criterion as jax_build_criterion
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_tpu.data.fixtures import write_bbbc_fixture
from pctrans_tpu.models import build_model_config as jax_model_config
from pctrans_torch import config
from pctrans_torch.data.synthetic import SyntheticDataset
from pctrans_torch.data.build import PrefetchLoader
from pctrans_torch.engine import checkpoint as ckpt
from pctrans_torch.engine.evaluator import Evaluator
from pctrans_torch.engine.trainer import Trainer
from pctrans_torch.data.synthetic import nuclei_scene_rule
from pctrans_torch.inference import metrics_bbbc as mb
from pctrans_torch.inference import metrics_cvppp as mc
from pctrans_torch.models import PCTransModel
from pctrans_torch.weights import load_flax_variables
from test_torch_slice import _randomize
from test_torch_train_step import LOSS_ATOL, LOSS_RTOL

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import eval_torch  # noqa: E402
import main_torch  # noqa: E402

torch.set_num_threads(1)

HW = 64
N_ITERS = 4


def tiny_opts(out: Path):
    """--opts of tests/test_trainer.py::tiny_cfg at 64x64."""
    return ["MODEL.RESNETS.DEPTH", "14", "MODEL.MASK_FORMER.HIDDEN_DIM", "32",
            "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.SEM_SEG_HEAD.MASK_DIM", "8",
            "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "10", "MODEL.MASK_FORMER.NHEADS", "4",
            "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
            "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
            "MODEL.MASK_FORMER.DEC_LAYERS", "4", "MODEL.SEM_SEG_HEAD.NORM", "GN",
            "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256", "MODEL.MAX_INSTANCES", "8",
            "MODEL.INPUT_SIZE", f"[{HW}, {HW}]", "DATASET.DATA_TYPE", "synthetic",
            "DATASET.OUTPUT_PATH", str(out / "out"),
            "INFERENCE.OUTPUT_PATH", str(out / "test"),
            "INFERENCE.SAMPLES_PER_BATCH", "3", "INFERENCE.TOP_K", "4",
            "SOLVER.ITERATION_TOTAL", str(N_ITERS), "SOLVER.ITERATION_SAVE", "2",
            "SOLVER.START_SAVE", "0", "SOLVER.ITERATION_VAL", str(N_ITERS),
            "SOLVER.SAMPLES_PER_BATCH", "1", "MONITOR.ITERATION_NUM", "[1, 200]",
            "MONITOR.TENSORBOARD", "False"]


def _reid_draws(key, step, batch, G, Q):
    """The JAX criterion's re-id uniforms at ``step`` (``state.py:74``)."""
    _, _, k_reid = jax.random.split(jax.random.fold_in(key, step), 3)
    return np.stack([np.asarray(jax.random.uniform(k, (G, Q)))
                     for k in jax.random.split(k_reid, batch)])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    opts = tiny_opts(tmp)
    jcfg = jax_config.load_cfg(opts=opts)
    cfg = config.load_cfg(opts=opts)
    mcfg = jax_model_config(jcfg)
    jmodel = JaxModel(config=mcfg, train=True)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, HW, HW, 3)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c,
                               np.random.RandomState(1))
                 for c, t in variables.items()}

    trainer = Trainer(cfg, mode="train", device="cpu")
    load_flax_variables(trainer.model, variables)
    key = jax.random.key(int(cfg.SYSTEM.get("SEED", 42)))
    G, Q, B = cfg.MODEL.MAX_INSTANCES, cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES, 1
    batches, step = [], trainer._train_step

    def recording_step(batch):
        draws = torch.from_numpy(_reid_draws(key, len(batches), B, G, Q))
        batches.append({k: batch[k] for k in ("image", "label")})
        return step(batch, reid_uniform=draws)

    trainer._train_step = recording_step
    trainer.train()

    tx = jax_build_optimizer(jcfg, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       frozen=variables.get("frozen", {}),
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state=tx.init(variables["params"]))
    jstep = jax.jit(jax_make_train_step(mcfg, jax_build_criterion(jcfg), tx, G))
    j_metrics = []
    for batch in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        j_metrics.append({k: float(v) for k, v in m.items()})
    return cfg, opts, tmp, trainer, j_metrics


def test_per_loss_records_match_jax_train_steps(run):
    cfg, _, tmp, _, j_metrics = run
    lines = [json.loads(l) for l in (tmp / "out" / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in lines if "eval" not in r]
    assert [r["iter"] for r in train] == list(range(N_ITERS))
    for rec, ref in zip(train, j_metrics):
        assert set(rec) - {"iter", "lr"} == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(rec[k], v, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=f"iter {rec['iter']} {k}")
    evals = [r for r in lines if "eval" in r]
    assert [r["iter"] for r in evals] == [N_ITERS]
    assert set(evals[0]["eval"]) == {"SBD", "absDiffFG"}


def test_checkpoints_best_and_log(run):
    cfg, _, tmp, trainer, _ = run
    out = tmp / "out"
    names = sorted(os.listdir(out))
    assert {"checkpoint_000002.pth.tar", "checkpoint_000004.pth.tar",
            "checkpoint_best.pth.tar", "config.yaml"} <= set(names)
    assert [ckpt.checkpoint_iteration(p) for p in ckpt.list_checkpoints(str(out))] == [2, 4]
    best = torch.load(out / "checkpoint_best.pth.tar", weights_only=True)
    assert best["iteration"] == N_ITERS
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(best["model"][k], v, rtol=0, atol=0)
    log = (tmp / "test" / "logging.txt").read_text().splitlines()
    assert log[0] == f"val_{N_ITERS:06d}" and len(log[1].split()) == 2
    assert float(log[1].split()[0]) == trainer.best_val
    images = np.random.RandomState(2).randn(2, HW, HW, 3).astype(np.float32)
    labels = trainer.predict_labels(images)
    assert labels.shape == (2, HW, HW) and labels.dtype == np.int16
    assert config.load_cfg(None, str(out / "config.yaml")).to_dict() == cfg.to_dict()


def test_eval_torch_sweeps_the_two_checkpoints(run):
    _, opts, tmp, trainer, _ = run
    out = tmp / "sweep.json"
    records = eval_torch.main(["--start", "0", "--out", str(out), "--device", "cpu",
                               "--opts", *opts])
    assert [r["iter"] for r in records] == [2, 4]
    assert json.loads(out.read_text()) == records
    assert all(set(r) == {"iter", "SBD", "absDiffFG"} for r in records)
    # checkpoint_000004 is the model that the in-training validation scored
    assert records[1]["SBD"] == trainer.best_val
    assert eval_torch.main(["--start", "5", "--device", "cpu", "--opts", *opts]) == []


def test_eval_cvppp_scores_only_the_valid_rows():
    """5 val images at batch 4: the loader pads the second batch with three
    copies of image 4 (``_num_valid`` 1); eval_cvppp scores 5 images."""
    cfg = config.ModelConfig(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10,
                             nheads=4, dim_feedforward=64, enc_layers=1, dec_layers=3,
                             backbone_depth=14, head_norm="GN")
    model = PCTransModel(cfg, generator=torch.Generator().manual_seed(3))
    ev = Evaluator(model, top_k=4)
    loader = PrefetchLoader(SyntheticDataset((HW, HW), length=5, seed=1), 4,
                            shuffle=False, loop=False, drop_last=False, pad_last=True)
    batches = list(loader)
    loader.close()
    assert [int(b["_num_valid"]) for b in batches] == [4, 1]
    sbd, dic = [], []
    for batch in batches:
        labels = ev.predict_labels(batch["image"])
        for b in range(labels.shape[0]):
            seg, gt = labels[b].astype(np.uint16), batch["label"][b].astype(np.uint16)
            sbd.append(mc.SymmetricBestDice(seg, gt))
            dic.append(abs(mc.DiffFGLabels(seg, gt)))
    res = ev.eval_cvppp(batches)
    assert res == {"SBD": np.mean(sbd[:5]), "absDiffFG": np.mean(dic[:5])}
    # scoring the padded rows too gives other numbers: the test has teeth
    assert (np.mean(sbd), np.mean(dic)) != (np.mean(sbd[:5]), np.mean(dic[:5]))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_cli_without_a_card_raises(tmp_path):
    opts = tiny_opts(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main_torch.main(["--opts", *opts])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        eval_torch.main(["--start", "0", "--opts", *opts])


def test_cli_distributed_raises(tmp_path, monkeypatch):
    """--distributed without the env:// variables of a launcher raises and
    names them: it never trains as an independent single process."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR.*torchrun"):
        main_torch.main(["--distributed", "--device", "cpu",
                         "--opts", *tiny_opts(tmp_path)])


@pytest.mark.parametrize("key,value,item", [
    ("DATASET.DATA_TYPE", "volume", "26"),
])
def test_unported_trainer_settings_raise(tmp_path, key, value, item):
    cfg = config.load_cfg(opts=tiny_opts(tmp_path) + [key, value])
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        Trainer(cfg, mode="train", device="cpu")


BBBC_METRICS = {"AJI", "F1", "detF1", "PQ"}


def bbbc_opts(out: Path, data_type="synthetic_bbbc"):
    """The tiny config on 64x64 nuclei scenes, 2 iterations, a checkpoint
    and a validation at 2."""
    return tiny_opts(out) + ["DATASET.DATA_TYPE", data_type, "SOLVER.ITERATION_TOTAL", "2",
                             "SOLVER.ITERATION_VAL", "2", "INFERENCE.SAMPLES_PER_BATCH", "2"]


@pytest.fixture(scope="module")
def bbbc_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bbbc")
    trainer = main_torch.main(["--device", "cpu", "--opts", *bbbc_opts(tmp)])
    return tmp, trainer


def test_bbbc_trains_validates_with_aji_and_keeps_the_best(bbbc_run):
    tmp, trainer = bbbc_run
    assert trainer.dataset == "bbbc" and trainer.evaluator.threshold == 0.05
    lines = [json.loads(l) for l in (tmp / "out" / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in lines if "eval" not in r] == [0, 1]
    evals = [r["eval"] for r in lines if "eval" in r]
    assert len(evals) == 1 and set(evals[0]) == BBBC_METRICS | {f"{k}_std" for k in BBBC_METRICS}
    log = (tmp / "test" / "logging.txt").read_text().splitlines()
    assert log[0] == "val_000002"
    assert [float(v) for v in log[1].split()] == [evals[0][k] for k in ("AJI", "F1", "detF1", "PQ")]
    assert trainer.best_val == evals[0]["AJI"]
    best = torch.load(tmp / "out" / "checkpoint_best.pth.tar", weights_only=True)
    assert best["iteration"] == 2
    assert sorted(f for f in os.listdir(tmp / "out") if f.endswith(".pth.tar")) == [
        "checkpoint_000002.pth.tar", "checkpoint_best.pth.tar"]
    images = np.random.RandomState(2).randn(2, HW, HW, 3).astype(np.float32)
    for ds in (None, "bbbc", "cvppp"):
        labels = trainer.predict_labels(images, ds)
        assert labels.shape == (2, HW, HW) and labels.dtype == np.int16


def test_eval_torch_routes_synthetic_bbbc_to_test_bbbc(bbbc_run):
    tmp, trainer = bbbc_run
    records = eval_torch.main(["--start", "0", "--device", "cpu",
                               "--opts", *bbbc_opts(tmp)])
    assert [r["iter"] for r in records] == [2]
    assert set(records[0]) == {"iter"} | BBBC_METRICS | {f"{k}_std" for k in BBBC_METRICS}
    assert all(np.isfinite(v) for v in records[0].values())
    log = (tmp / "test" / "logging.txt").read_text().splitlines()
    assert log[-2] == "checkpoint_000002.pth.tar" and len(log[-1].split()) == 4


def test_main_torch_inference_dispatches_as_the_jax_script(bbbc_run, tmp_path):
    """``--inference``: BBBC scores test_bbbc over its test split; a type with
    no inference path (synthetic_bbbc, as in scripts/main.py) raises."""
    tmp, _ = bbbc_run
    ckpt_path = str(tmp / "out" / "checkpoint_best.pth.tar")
    write_bbbc_fixture(str(tmp_path / "bbbc"), n_train=1, n_val=1, n_test=3, size=(48, 56))
    opts = bbbc_opts(tmp_path, "BBBC") + ["DATASET.INPUT_PATH", str(tmp_path / "bbbc")]
    trainer = main_torch.main(["--inference", "--checkpoint", ckpt_path, "--device", "cpu",
                               "--opts", *opts])
    log = (tmp_path / "test" / "logging.txt").read_text().splitlines()
    assert log[0] == "checkpoint_best.pth.tar" and len(log[1].split()) == 4
    assert trainer.dataset == "bbbc"
    with pytest.raises(ValueError, match="No inference path for DATA_TYPE=synthetic_bbbc"):
        main_torch.main(["--inference", "--checkpoint", ckpt_path, "--device", "cpu",
                         "--opts", *bbbc_opts(tmp_path)])


def test_test_bbbc_scores_only_the_valid_rows():
    """5 nuclei scenes at batch 4: test_bbbc scores 5 images, not the three
    copies of image 4 that pad the second batch."""
    cfg = config.ModelConfig(hidden_dim=32, conv_dim=32, mask_dim=8, num_queries=10,
                             nheads=4, dim_feedforward=64, enc_layers=1, dec_layers=3,
                             backbone_depth=14, head_norm="GN")
    ev = Evaluator(PCTransModel(cfg, generator=torch.Generator().manual_seed(3)),
                   top_k=4, dataset="bbbc")
    n_inst, radius = nuclei_scene_rule((HW, HW))
    loader = PrefetchLoader(SyntheticDataset((HW, HW), length=5, seed=1, n_instances=n_inst,
                                             radius_px=radius),
                            4, shuffle=False, loop=False, drop_last=False, pad_last=True)
    batches = list(loader)
    loader.close()
    assert [int(b["_num_valid"]) for b in batches] == [4, 1]
    scores = []
    for batch in batches:
        for seg, gt in zip(ev.predict_labels(batch["image"]), batch["label"]):
            gt, seg = mb.remap_label(gt), mb.remap_label(seg)
            scores.append([mb.agg_jc_index(gt, seg), mb.pixel_f1(gt, seg),
                           *mb.get_fast_pq(gt, seg)[0][::2]])
    res = ev.test_bbbc(batches)
    valid = np.array(scores[:5])
    assert res == {k: f(valid[:, i]) for i, k in enumerate(("AJI", "F1", "detF1", "PQ"))
                   for k, f in ((k, lambda v: float(np.mean(v))),
                                (f"{k}_std", lambda v: float(np.std(v))))}
    assert not np.allclose(np.mean(scores, axis=0), valid.mean(axis=0))
