"""Multi-card training on the CPU: two gloo ranks of the port, each a
subprocess (``tests/torch_dist_worker.py``) at a per-rank batch of 2,
against (i) one port process at the global batch of 4 and (ii) the JAX
package's ``make_train_step`` jitted over a 2-device CPU mesh
(``create_mesh(2)``, ``shard_batch``, ``replicate``), on the same weights
(the tiny config of ``tests/test_torch_train_step.py``, SyncBN heads),
batch and re-id draws.

Compared: every loss, every gradient, the SyncBN running statistics and
one AdamW update (BASE_LR 1e-2 without warmup, so that an f32 update is
resolved: Adam's first step is lr * g / (|g| + 1e-8) per element).
Tolerances, f32: 1e-5 against the one-process port (rel-Fro per gradient
and update; the ranks sum their statistics and gradients in another order),
the composed tests' against JAX (losses rtol 1e-4, gradients rel-Fro 1e-3,
statistics 1e-5).  An update is compared where its gradient is above 1e-3
of its tensor's largest and above 1e-5: Adam's first step maps every other
element to O(lr) whatever its size (the random backbone's early gradients
are ~1e-12, near Adam's epsilon), so a rounding-level difference of a tiny
gradient becomes an O(lr) difference of its update.  Gradients that are
zero in exact arithmetic (``EXACT_ZERO``) are bounded in absolute size
instead.

Also: ``num_masks`` and the other normalisers with a rank holding no
instance, the disjoint per-rank sampling of the loader, and rank-0-only
writes of ``main_torch.py --distributed``.  Every subprocess runs under a
timeout, and the process group's own is 60 s.
"""

import copy
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu.config import get_cfg_defaults
from pctrans_tpu.data import build as jax_build
from pctrans_tpu.engine.solver import build_optimizer as jax_build_optimizer
from pctrans_tpu.engine.state import TrainState
from pctrans_tpu.engine.state import make_train_step as jax_make_train_step
from pctrans_tpu.losses import CriterionConfig as JaxCriterionConfig
from pctrans_tpu.losses import SetCriterion as JaxCriterion
from pctrans_tpu.models import ModelConfig as JaxConfig
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_tpu.parallel import create_mesh, replicate, shard_batch
from pctrans_torch import config
from pctrans_torch.config import ModelConfig
from pctrans_torch.data import build
from pctrans_torch.data.synthetic import SyntheticDataset, make_blob_image
from pctrans_torch.engine.solver import (build_lr_scheduler, build_optimizer,
                                         build_solver_config)
from pctrans_torch.engine.train_step import make_train_step
from pctrans_torch.losses.criterion import CriterionConfig, SetCriterion
from pctrans_torch.models import PCTransModel
from pctrans_torch.weights import load_flax_variables
from test_torch_slice import _randomize
from test_torch_train_step import (CRIT, EXACT_ZERO, GRAD_REL_FRO, LOSS_ATOL, LOSS_RTOL,
                                   STATS_RTOL, TINY, _as_torch, _recording)
from test_torch_trainer import tiny_opts

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"
HW, WORLD, GLOBAL, G = (64, 64), 2, 4, 8
PORT_TOL = 1e-5
SOLVER_OPTS = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0"]
KW = dict(TINY, head_norm="SyncBN")
PROC_TIMEOUT = 240           # seconds for each rank's subprocess
PG_TIMEOUT = 60              # seconds for a collective


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(spec: dict, tmp: Path):
    """Both ranks as subprocesses; a rank that fails or outlasts
    PROC_TIMEOUT fails the test (the others are killed)."""
    spec = dict(spec, world=WORLD, port=_free_port(), timeout=PG_TIMEOUT)
    path = tmp / f"spec_{spec['kind']}_{spec['port']}.json"
    path.write_text(json.dumps(spec))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(path), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return logs


def _batch(counts, seed=0):
    """GLOBAL images with ``counts`` instances each (0: an empty image)."""
    rng = np.random.RandomState(seed)
    images, labels = [], []
    for n in counts:
        img, lab = make_blob_image(rng, HW, n_instances=(max(n, 1), max(n, 1)))
        images.append(img)
        labels.append(lab if n else np.zeros_like(lab))
    return {"image": np.stack(images).astype(np.float32), "label": np.stack(labels)}


def _reid_draws(rng_key, batch):
    """The JAX criterion's re-id uniforms of the global batch at step 0."""
    _, _, k_reid = jax.random.split(jax.random.fold_in(rng_key, 0), 3)
    return np.stack([np.asarray(jax.random.uniform(k, (G, TINY["num_queries"])))
                     for k in jax.random.split(k_reid, batch)])


def _one_process(model, batch, draws):
    """The port's step on the whole global batch in this process."""
    solver = build_solver_config(config.load_cfg(opts=SOLVER_OPTS))
    opt = build_optimizer(model, solver)
    step = make_train_step(model, SetCriterion(CriterionConfig(**CRIT)), opt,
                           build_lr_scheduler(opt, solver), G)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = step(batch, reid_uniform=torch.from_numpy(draws))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "update": {n: p.detach() - before[n] for n, p in model.named_parameters()},
            "buffers": dict(model.named_buffers())}


def _ranks(tmp, initial, batch, draws, name):
    """The two ranks' results, with their updates."""
    torch.save(initial.state_dict(), tmp / f"{name}_weights.pt")
    np.savez(tmp / f"{name}_batch.npz", **batch)
    np.save(tmp / f"{name}_draws.npy", draws)
    _launch({"kind": "step", "model": KW, "criterion": CRIT, "max_instances": G,
             "solver_opts": SOLVER_OPTS, "weights": str(tmp / f"{name}_weights.pt"),
             "batch": str(tmp / f"{name}_batch.npz"),
             "draws": str(tmp / f"{name}_draws.npy"), "out": str(tmp / name)}, tmp)
    out = [torch.load(tmp / f"{name}.{r}.pt", weights_only=True) for r in range(WORLD)]
    before = dict(initial.named_parameters())
    for o in out:
        o["update"] = {n: p - before[n].detach() for n, p in o["params"].items()}
    return out


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    # unequal instance counts per rank: 3 on rank 0, 7 on rank 1
    batch = _batch([1, 2, 3, 4])
    jmodel = JaxModel(config=JaxConfig(**KW), train=True)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, *HW, 3)))
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c,
                               np.random.RandomState(1))
                 for c, t in variables.items()}
    params = variables["params"]
    cfg = get_cfg_defaults()
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    tx = _recording(jax_build_optimizer(cfg, params))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       frozen=variables.get("frozen", {}),
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state=tx.init(params))
    mesh2 = create_mesh(2)
    step = jax.jit(jax_make_train_step(JaxConfig(**KW), JaxCriterion(JaxCriterionConfig(**CRIT)),
                                       tx, max_instances=G))
    rng_key = jax.random.key(0)
    new_state, j_metrics = step(replicate(mesh2, state), shard_batch(mesh2, batch), rng_key)
    j_new = jax.tree_util.tree_map(np.asarray, new_state.params)
    j_update = _as_torch(jax.tree_util.tree_map(lambda a, b: a - b, j_new, params), params)

    initial = PCTransModel(ModelConfig(**KW))
    load_flax_variables(initial, variables)
    draws = _reid_draws(rng_key, GLOBAL)
    single = _one_process(copy.deepcopy(initial), batch, draws)
    ranks = _ranks(tmp, initial, batch, draws, "main")
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state[1])
    return dict(batch=batch, params=params, initial=initial, single=single, ranks=ranks,
                j_metrics={k: float(v) for k, v in j_metrics.items()},
                j_grads=_as_torch(grads, params), j_update=j_update,
                j_stats=jax.tree_util.tree_map(np.asarray, dict(new_state.batch_stats)))


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_losses_are_the_global_batch_losses(run, rank):
    """Each rank reports the global batch's losses: the one process's within
    1e-5 and JAX's mesh step's within the composed tests' tolerance."""
    ours = run["ranks"][rank]["metrics"]
    assert set(ours) == set(run["single"]["metrics"]) == set(run["j_metrics"])
    for k, v in run["single"]["metrics"].items():
        np.testing.assert_allclose(ours[k], v, rtol=PORT_TOL, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(ours[k], run["j_metrics"][k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


def _check_grads(ours, ref, tol):
    largest = max(float(g.norm()) for g in ref.values())
    assert set(ours) == set(ref)
    for name, r in ref.items():
        if EXACT_ZERO.search(name) or float(r.norm()) == 0:
            assert max(float(ours[name].norm()), float(r.norm())) <= 1e-5 * largest, name
        else:
            assert _rel(ours[name], r) <= tol, (name, _rel(ours[name], r))


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_gradients_are_the_global_batch_gradients(run, rank):
    """After the all-reduce every rank holds the global batch's gradient."""
    _check_grads(run["ranks"][rank]["grads"], run["single"]["grads"], PORT_TOL)
    _check_grads(run["ranks"][rank]["grads"], run["j_grads"], GRAD_REL_FRO)


@pytest.mark.parametrize("rank", range(WORLD))
def test_syncbn_running_statistics_are_global(run, rank):
    """SyncBN's running mean and (biased) variance after the step equal the
    one process's and JAX's batch_stats over the mesh."""
    from pctrans_torch.weights import _flatten, torch_key

    bufs = run["ranks"][rank]["buffers"]
    stats = list(_flatten(run["j_stats"]))
    assert stats
    for path, ref in stats:
        key = torch_key("batch_stats", path, run["params"])
        single = run["single"]["buffers"][key].numpy()
        np.testing.assert_allclose(bufs[key].numpy(), single, rtol=PORT_TOL,
                                   atol=PORT_TOL * np.abs(single).max(), err_msg=key)
        np.testing.assert_allclose(bufs[key].numpy(), ref, rtol=STATS_RTOL,
                                   atol=STATS_RTOL * np.abs(ref).max(), err_msg=key)


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_adamw_update_is_the_global_batch_update(run, rank):
    ours = run["ranks"][rank]["update"]
    n_checked = 0
    for name, ref in run["single"]["update"].items():
        if EXACT_ZERO.search(name):
            continue
        g = run["j_grads"][name].abs()
        sure = (g > 1e-3 * g.max()) & (g > 1e-5)
        if not sure.any():
            continue
        assert _rel(ours[name][sure], ref[sure]) <= PORT_TOL, name
        assert _rel(ours[name][sure], run["j_update"][name][sure]) <= GRAD_REL_FRO, name
        n_checked += 1
    assert n_checked > 0.5 * len(ours)


def test_ranks_hold_equal_parameters_after_the_step(run):
    a, b = (r["params"] for r in run["ranks"])
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_a_rank_without_instances_keeps_the_global_normalisers(tmp_path):
    """Rank 1's two images hold no instance and rank 0's hold 2 and 5: the
    mask, reference-point and re-id terms divide by the global counts, so
    both ranks report and step as one process at the global batch."""
    batch = _batch([2, 5, 0, 0], seed=3)
    model = PCTransModel(ModelConfig(**KW), generator=torch.Generator().manual_seed(0))
    draws = np.random.RandomState(4).rand(GLOBAL, G, TINY["num_queries"]).astype(np.float32)
    single = _one_process(copy.deepcopy(model), batch, draws)
    ranks = _ranks(tmp_path, model, batch, draws, "empty")
    for r in ranks:
        for k, v in single["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=PORT_TOL, atol=1e-7,
                                       err_msg=k)
        _check_grads(r["grads"], single["grads"], PORT_TOL)
    assert single["metrics"]["loss_mask"] > 0


def test_per_rank_sampling_is_a_disjoint_stride_of_the_epoch():
    """Each of two processes takes every other item of each epoch's
    permutation, batch by batch the JAX loader's share; together they cover
    the epoch once."""
    kw = dict(size=(24, 20), length=12, seed=3, n_instances=(2, 5))
    seen = []
    for r in range(WORLD):
        ours = build.PrefetchLoader(SyntheticDataset(**kw), 3, shuffle=True, seed=5,
                                    num_workers=2, process_index=r, process_count=WORLD)
        ref = jax_build.PrefetchLoader(SyntheticDataset(**kw), 3, shuffle=True, seed=5,
                                       num_workers=2, process_index=r, process_count=WORLD)
        idx = [list(i) for i in ours._epoch_indices(0)]
        assert idx == [list(i) for i in ref._epoch_indices(0)]
        seen += [i for b in idx for i in b]
        a, b = iter(ours), iter(ref)
        for _ in range(3):
            x, y = next(a), next(b)
            assert all(np.array_equal(x[k], y[k]) for k in y)
        ours.close()
        ref.close()
    assert sorted(seen) == list(range(12))


def test_loader_refuses_a_global_batch_that_does_not_split():
    cfg = config.load_cfg(opts=["DATASET.DATA_TYPE", "CVPPP"])
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        build.build_dataloader(cfg, "val", process_index=0, process_count=3)


def test_only_rank_zero_writes(tmp_path):
    """``main_torch.py --distributed`` on two gloo ranks: one config, one
    record per logged iteration and one validation entry, the checkpoints
    of one run, and nothing else in the output directories."""
    opts = tiny_opts(tmp_path) + ["SOLVER.SAMPLES_PER_BATCH", "1",
                                  "MONITOR.PROFILE_ITERS", "[1, 2]"]
    logs = _launch({"kind": "main", "argv": ["--opts", *opts]}, tmp_path)
    out = tmp_path / "out"
    assert sorted(p.name for p in out.iterdir()) == [
        "checkpoint_000002.pth.tar", "checkpoint_000004.pth.tar", "checkpoint_best.pth.tar",
        "config.yaml", "metrics.jsonl", "profile", "vis"]
    records = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in records if "eval" not in r] == [0, 1, 2, 3]
    assert sum("eval" in r for r in records) == 1
    assert len((tmp_path / "test" / "logging.txt").read_text().splitlines()) == 2
    assert len(list((out / "profile").iterdir())) == 1
    assert sum("[Iteration" in log for log in logs) == 1
