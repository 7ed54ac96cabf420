"""The port's datasets and loader against the JAX package's: the same
batches, bit for bit, from ``build_dataloader`` for ``synthetic`` and for a
CVPPP tree written by ``pctrans_tpu/data/fixtures.py``."""

import numpy as np
import pytest

from pctrans_tpu import config as jax_config
from pctrans_tpu.data import build as jax_build
from pctrans_tpu.data.fixtures import write_cvppp_fixture
from pctrans_tpu.data.label_utils import relabel_consecutive as jax_relabel
from pctrans_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from pctrans_tpu.data.synthetic import batch_iterator as jax_batch_iterator
from pctrans_torch import config
from pctrans_torch.data import build
from pctrans_torch.data.label_utils import relabel_consecutive
from pctrans_torch.data.synthetic import SyntheticDataset, batch_iterator


def _cfgs(opts):
    return config.load_cfg(opts=opts), jax_config.load_cfg(opts=opts)


def _batches(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    it.close()
    loader.close()
    return out


def _epoch(loader):
    out = list(loader)
    loader.close()
    return out


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_relabel_consecutive_matches_jax():
    rng = np.random.RandomState(0)
    for seg in (rng.randint(0, 40, (17, 13)), rng.randint(3, 9, (8, 8)),
                np.zeros((4, 4), np.uint8), rng.randint(0, 300, (9, 9)).astype(np.uint16)):
        ours, ref = relabel_consecutive(seg), jax_relabel(seg)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


SYNTH = ["DATASET.DATA_TYPE", "synthetic", "MODEL.INPUT_SIZE", "[40, 36]",
         "SOLVER.SAMPLES_PER_BATCH", "3", "INFERENCE.SAMPLES_PER_BATCH", "3",
         "MODEL.MAX_INSTANCES", "8"]


def test_synthetic_train_batches_equal_the_jax_loader():
    ours, ref = _cfgs(SYNTH)
    # 64 items at batch 3: batch 22 starts the second epoch's permutation
    _assert_same(_batches(build.build_dataloader(ours, "train"), 23),
                 _batches(jax_build.build_dataloader(ref, "train"), 23))


def test_synthetic_val_epoch_is_padded_with_num_valid():
    ours, ref = _cfgs(SYNTH)
    batches = _epoch(build.build_dataloader(ours, "val"))
    _assert_same(batches, _epoch(jax_build.build_dataloader(ref, "val")))
    assert [int(b["_num_valid"]) for b in batches] == [3, 3, 2]
    np.testing.assert_array_equal(batches[-1]["image"][2], batches[-1]["image"][1])


def test_cvppp_train_and_val_items_equal_jax(tmp_path):
    write_cvppp_fixture(str(tmp_path), n_train=3, n_val=2, n_test=0, size=(60, 50))
    opts = ["DATASET.INPUT_PATH", str(tmp_path), "MODEL.INPUT_SIZE", "[32, 32]",
            "SOLVER.SAMPLES_PER_BATCH", "2"]
    ours, ref = _cfgs(opts)
    train = _batches(build.build_dataloader(ours, "train", seed=5), 4)
    _assert_same(train, _batches(jax_build.build_dataloader(ref, "train", seed=5), 4))
    assert train[0]["image"].shape == (2, 32, 32, 3)
    val = _epoch(build.build_dataloader(ours, "val"))
    _assert_same(val, _epoch(jax_build.build_dataloader(ref, "val")))
    assert int(val[0]["_num_valid"]) == 2 and val[0]["image"].shape == (10, 60, 50, 3)


@pytest.mark.parametrize("data_type,item", [
    ("BBBC", "21"), ("synthetic_bbbc", "21"), ("cellpose", "21a"),
    ("monuseg", "21a"), ("volume", "26"), ("tile", "26")])
def test_unported_datasets_name_their_roadmap_item(data_type, item):
    cfg = config.load_cfg(opts=["DATASET.DATA_TYPE", data_type])
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item} "):
        build.get_dataset(cfg, "train")


@pytest.mark.parametrize("data_type", ["CVPPP", "synthetic"])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_batch_size_matches_jax(data_type, mode):
    ours, ref = _cfgs(["DATASET.DATA_TYPE", data_type])
    assert build.batch_size_for(ours, mode) == jax_build.batch_size_for(ref, mode)


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_matches_jax(shuffle):
    kw = dict(size=(24, 20), length=7, seed=3, n_instances=(2, 5))
    ours = batch_iterator(SyntheticDataset(**kw), 3, np.random.RandomState(0), shuffle)
    ref = jax_batch_iterator(JaxSynthetic(**kw), 3, np.random.RandomState(0), shuffle)
    # 7 items at batch 3: two batches per pass, then a new permutation
    _assert_same([next(ours) for _ in range(5)], [next(ref) for _ in range(5)])
