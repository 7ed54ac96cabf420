"""The port's datasets and loader against the JAX package's: the same
batches, bit for bit, from ``build_dataloader`` for ``synthetic`` and
``synthetic_bbbc`` and for CVPPP and BBBC trees written by
``pctrans_tpu/data/fixtures.py``."""

import numpy as np
import pytest

from pctrans_tpu import config as jax_config
from pctrans_tpu.data import build as jax_build
from pctrans_tpu.data import bbbc as jax_bbbc
from pctrans_tpu.data.fixtures import write_bbbc_fixture, write_cvppp_fixture
from pctrans_tpu.data.label_utils import relabel_consecutive as jax_relabel
from pctrans_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from pctrans_tpu.data.synthetic import batch_iterator as jax_batch_iterator
from pctrans_torch import config
from pctrans_torch.data import bbbc, build
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


@pytest.fixture(scope="module")
def bbbc_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bbbc")
    write_bbbc_fixture(str(root), n_train=3, n_val=2, n_test=3, size=(60, 70))
    return str(root)


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_bbbc_items_equal_jax(bbbc_tree, mode):
    """Every item of each split, train items under eight per-item streams
    (each augmentation branch taken by some), equal to JAX's."""
    ours = bbbc.BBBC(bbbc_tree, mode, crop_size=(32, 32))
    ref = jax_bbbc.BBBC(bbbc_tree, mode, crop_size=(32, 32))
    assert ours.ids == ref.ids and len(ours) == {"train": 3, "validation": 2, "test": 3}[mode]
    seeds = range(8) if mode == "train" else [None]
    for i in range(len(ours)):
        for seed in seeds:
            rng = lambda: None if seed is None else np.random.RandomState(seed)  # noqa: E731
            a, b = ours.__getitem__(i, rng=rng()), ref.__getitem__(i, rng=rng())
            _assert_same([a], [b])
    shape = {"train": (32, 32), "validation": (244, 78), "test": (60, 70)}[mode]
    assert a["image"].shape == shape + (3,) and a["label"].shape == shape


def test_bbbc_loader_batches_equal_jax(bbbc_tree):
    opts = ["DATASET.DATA_TYPE", "BBBC", "DATASET.INPUT_PATH", bbbc_tree,
            "MODEL.INPUT_SIZE", "[32, 32]", "SOLVER.SAMPLES_PER_BATCH", "2",
            "INFERENCE.SAMPLES_PER_BATCH", "2"]
    ours, ref = _cfgs(opts)
    _assert_same(_batches(build.build_dataloader(ours, "train", seed=3), 4),
                 _batches(jax_build.build_dataloader(ref, "train", seed=3), 4))
    test = _epoch(build.build_dataloader(ours, "test"))
    _assert_same(test, _epoch(jax_build.build_dataloader(ref, "test")))
    assert [int(b["_num_valid"]) for b in test] == [2, 1]


@pytest.mark.parametrize("aug", ["flip", "rotate", "elastic", "grayscale"])
def test_bbbc_augmentations_equal_jax(aug):
    rng = np.random.RandomState(4)
    img = rng.rand(40, 40).astype(np.float32)
    label = rng.randint(0, 6, (40, 40)).astype(np.int32)
    if aug == "grayscale":
        np.testing.assert_array_equal(bbbc.aug_grayscale(np.random.RandomState(1), img),
                                      jax_bbbc.aug_grayscale(np.random.RandomState(1), img))
        return
    fn = f"aug_{aug}"
    a = getattr(bbbc, fn)(np.random.RandomState(1), img, label)
    b = getattr(jax_bbbc, fn)(np.random.RandomState(1), img, label)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(bbbc.center_crop_2d(a[0], (24, 30)),
                                  jax_bbbc.center_crop_2d(b[0], (24, 30)))


SYNTH_BBBC = ["DATASET.DATA_TYPE", "synthetic_bbbc", "MODEL.INPUT_SIZE", "[72, 64]",
              "SOLVER.SAMPLES_PER_BATCH", "2", "INFERENCE.SAMPLES_PER_BATCH", "3",
              "MODEL.MAX_INSTANCES", "4"]


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_synthetic_bbbc_batches_equal_the_jax_loader(mode):
    """The nuclei rule at 72x64: 2-4 nuclei of radius 3.6-12.8 px; the
    MAX_INSTANCES 4 truncation warning counts alike."""
    ours, ref = _cfgs(SYNTH_BBBC)
    if mode == "train":
        got = _batches(build.build_dataloader(ours, "train"), 5)
        _assert_same(got, _batches(jax_build.build_dataloader(ref, "train"), 5))
    else:
        got = _epoch(build.build_dataloader(ours, mode))
        _assert_same(got, _epoch(jax_build.build_dataloader(ref, mode)))
        assert [int(b["_num_valid"]) for b in got] == [3, 3, 2]
    assert max(int(b["label"].max()) for b in got) >= 3


@pytest.mark.parametrize("data_type,item", [
    ("cellpose", "21a"), ("monuseg", "21a"), ("volume", "26"), ("tile", "26")])
def test_unported_datasets_name_their_roadmap_item(data_type, item):
    cfg = config.load_cfg(opts=["DATASET.DATA_TYPE", data_type])
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item} "):
        build.get_dataset(cfg, "train")


@pytest.mark.parametrize("data_type", ["CVPPP", "synthetic", "BBBC", "synthetic_bbbc"])
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
