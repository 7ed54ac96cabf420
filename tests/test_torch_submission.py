"""The CVPPP submission: the fixture's test split (rgb + fg, no labels;
``pctrans_tpu/data/fixtures.py``) through both packages' ``test_cvppp`` on
the tiny config of ``tests/test_torch_trainer.py`` with the same weights
(f32); the two ``submission.h5`` files hold the same groups and equal u8
datasets.  Also ``merge_func`` / ``merge_small_object`` against the JAX
package's on label maps with many small objects, the test split's items
against JAX's, the ``(plant, seg)`` generator, and the writer's h5py need."""

import builtins

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctrans_tpu import config as jax_config
from pctrans_tpu.data.cvppp import CVPPP as JaxCVPPP
from pctrans_tpu.data.cvppp import TEST_PLANTS as JAX_TEST_PLANTS
from pctrans_tpu.data.fixtures import write_cvppp_fixture
from pctrans_tpu.engine.trainer import Trainer as JaxTrainer
from pctrans_tpu.inference.postprocess import merge_func as jax_merge_func
from pctrans_tpu.inference.postprocess import merge_small_object as jax_merge_small
from pctrans_tpu.models import PCTransModel as JaxModel
from pctrans_tpu.parallel import replicate
from pctrans_torch import config
from pctrans_torch.data.cvppp import CVPPP, TEST_PLANTS
from pctrans_torch.engine.trainer import Trainer, write_submission
from pctrans_torch.inference.postprocess import merge_func, merge_small_object
from pctrans_torch.weights import load_flax_variables
from test_torch_slice import _randomize
from test_torch_trainer import HW, tiny_opts

torch.set_num_threads(1)

N_TEST = 4                   # at INFERENCE.SAMPLES_PER_BATCH 3: a padded last batch


def _small_objects(seed):
    """A label map of a few large regions speckled with 1-60 pixel objects,
    some at the borders (where the reference's wrapped crop leaves them)."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((40, 36), np.int32)
    seg[:, 18:] = 1
    seg[20:, :] = 2
    seg[5:15, 3:12] = 3
    nxt = 4
    for _ in range(25):
        h, w = rng.randint(1, 8), rng.randint(1, 8)
        y, x = rng.randint(0, 40 - h), rng.randint(0, 36 - w)
        seg[y:y + h, x:x + w] = nxt
        nxt += 1
    return seg


@pytest.mark.parametrize("seed", range(6))
def test_merge_func_equals_jax(seed):
    seg = _small_objects(seed)
    np.testing.assert_array_equal(merge_func(seg), jax_merge_func(seg))
    for thr, win in ((5, 5), (20, 11), (50, 11)):
        np.testing.assert_array_equal(merge_small_object(seg, thr, win),
                                      jax_merge_small(seg, thr, win))
    assert len(np.unique(merge_func(seg))) < len(np.unique(seg))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("submission")
    names = write_cvppp_fixture(str(tmp / "data"), n_train=1, n_val=1, n_test=N_TEST,
                                size=(HW, HW), seed=2)
    opts = tiny_opts(tmp) + ["DATASET.DATA_TYPE", "CVPPP",
                             "DATASET.INPUT_PATH", str(tmp / "data")]
    jcfg = jax_config.load_cfg(opts=opts)
    jtrainer = JaxTrainer(jcfg, mode="test")
    jmodel = JaxModel(config=jtrainer.model_config, train=True)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, HW, HW, 3)))
    # weights whose masks overlap the fixture's foreground on most plants
    variables = {c: _randomize(jax.tree_util.tree_map(np.asarray, dict(t)), c,
                               np.random.RandomState(3))
                 for c, t in variables.items()}
    jtrainer.state = replicate(jtrainer.mesh, jtrainer.state.replace(
        params=variables["params"], frozen=variables.get("frozen", {}),
        batch_stats=variables.get("batch_stats", {})))
    j_path = jtrainer.test_cvppp(submission=str(tmp / "jax.h5"))

    trainer = Trainer(config.load_cfg(opts=opts), mode="test", device="cpu")
    load_flax_variables(trainer.model, variables)
    path = trainer.test_cvppp(submission=str(tmp / "port.h5"))
    return tmp, names, trainer, path, j_path


def test_submission_equals_the_jax_submission(run):
    _, _, _, path, j_path = run
    with h5py.File(path, "r") as f, h5py.File(j_path, "r") as g:
        assert list(f) == list(g) == ["A1"]
        assert list(f["A1"]) == list(g["A1"]) == sorted(TEST_PLANTS[:N_TEST])
        for plant in g["A1"]:
            ours, ref = f["A1"][plant]["label"][()], g["A1"][plant]["label"][()]
            assert ours.dtype == ref.dtype == np.uint8 and ours.shape == (HW, HW)
            np.testing.assert_array_equal(ours, ref, err_msg=plant)
        assert sum(int(f["A1"][p]["label"][()].max()) > 0 for p in f["A1"]) >= 2


def test_submission_generator_yields_plants_in_order(run):
    tmp, _, trainer, path, _ = run
    out = list(trainer.cvppp_submission())
    assert [p for p, _ in out] == TEST_PLANTS[:N_TEST] == JAX_TEST_PLANTS[:N_TEST]
    with h5py.File(path, "r") as f:
        for plant, seg in out:
            np.testing.assert_array_equal(seg, f["A1"][plant]["label"][()])
            assert not seg[np.asarray(CVPPP(str(tmp / "data"), "test")[
                TEST_PLANTS.index(plant)]["fg"]) == 0].any()      # masked by fg


def test_test_split_items_equal_jax(run):
    tmp = run[0]
    ours, ref = CVPPP(str(tmp / "data"), "test"), JaxCVPPP(str(tmp / "data"), "test")
    assert ours.plants == ref.plants == run[1]["test"]
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) == {"image", "fg"}
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_writer_names_h5py_when_it_is_missing(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs the h5py package"):
        write_submission(str(tmp_path / "s.h5"), iter([("plant003", np.zeros((2, 2)))]))
    assert not (tmp_path / "s.h5").exists()
