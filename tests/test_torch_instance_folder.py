"""The cellpose and MoNuSeg instance-folder datasets against the JAX
package's on on-disk fixtures written here: the listing and split, every
item of every mode (train items with the same per-item random stream),
``DATASET.DATA_TYPE`` dispatch and the loader's batches."""

import numpy as np
import pytest
import torch
from PIL import Image

from pctrans_tpu.config import load_cfg as jax_load_cfg
from pctrans_tpu.data import build as jax_build
from pctrans_tpu.data.instance_folder import CellposeDataset as JaxCellpose
from pctrans_tpu.data.instance_folder import MoNuSegDataset as JaxMoNuSeg
from pctrans_torch import config
from pctrans_torch.data import build
from pctrans_torch.data.instance_folder import CellposeDataset, MoNuSegDataset
from pctrans_torch.data.synthetic import make_blob_image

torch.set_num_threads(1)

CROP = 48


def _scene(rng, size):
    img, label = make_blob_image(rng, size, n_instances=(3, 6))
    rgb = (np.clip(img * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
    return rgb, label


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("folders")
    rng = np.random.RandomState(0)
    cell = tmp / "cellpose"
    for split, n in (("train", 3), ("test", 2)):
        (cell / split).mkdir(parents=True)
        for i in range(n):
            rgb, label = _scene(rng, (60, 52))
            Image.fromarray(rgb).save(cell / split / f"{i:03d}_img.png")
            Image.fromarray(label.astype(np.uint16)).save(cell / split / f"{i:03d}_masks.png")
    mono = tmp / "monuseg"
    (mono / "images").mkdir(parents=True)
    (mono / "labels").mkdir()
    for i in range(6):
        rgb, label = _scene(rng, (56, 64))
        stem = f"TCGA-{i:02d}"
        Image.fromarray(rgb).save(mono / "images" / f"{stem}.png")
        if i == 4:              # a rescaled export: the label is another size
            label = label[::2, ::2]
            np.save(mono / "labels" / f"{stem}_300_ins.npy", label)
        elif i != 5:            # no label: left out of the listing
            np.save(mono / "labels" / f"{stem}_ins.npy", label)
    return {"cellpose": str(cell), "monuseg": str(mono)}


def _assert_items_equal(ours, ref, mode):
    assert [tuple(map(str, p)) for p in ours.items] == [tuple(map(str, p)) for p in ref.items]
    for i in range(len(ref)):
        kw = [dict(rng=np.random.RandomState(i)) for _ in range(2)] if mode == "train" \
            else [{}, {}]
        a, b = ours.__getitem__(i, **kw[0]), ref.__getitem__(i, **kw[1])
        assert set(a) == set(b) == {"image", "label"}
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
        if mode == "train":
            assert a["image"].shape == (CROP, CROP, 3)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("name", ["cellpose", "monuseg"])
def test_items_equal_jax(roots, name, mode):
    ours_cls, ref_cls = {"cellpose": (CellposeDataset, JaxCellpose),
                         "monuseg": (MoNuSegDataset, JaxMoNuSeg)}[name]
    ours, ref = ours_cls(roots[name], mode, crop_size=CROP), ref_cls(roots[name], mode,
                                                                    crop_size=CROP)
    assert len(ours) == len(ref) > 0
    _assert_items_equal(ours, ref, mode)


def test_monuseg_split_and_rescaled_labels(roots):
    sizes = {m: len(MoNuSegDataset(roots["monuseg"], m)) for m in ("train", "val", "test")}
    assert sizes == {"train": 4, "val": 1, "test": 5}
    ds = MoNuSegDataset(roots["monuseg"], "test")
    rescaled = [i for i, (_, lp) in enumerate(ds.items) if lp.endswith("_300_ins.npy")]
    assert ds[rescaled[0]]["image"].shape[:2] == (28, 32)


@pytest.mark.parametrize("data_type", ["cellpose", "monuseg"])
def test_dispatch_and_loader_batches_equal_jax(roots, data_type):
    opts = ["DATASET.DATA_TYPE", data_type, "DATASET.INPUT_PATH", roots[data_type],
            "MODEL.INPUT_SIZE", f"[{CROP}, {CROP}]", "SOLVER.SAMPLES_PER_BATCH", "2"]
    cfg, jcfg = config.load_cfg(opts=opts), jax_load_cfg(opts=opts)
    ds = build.get_dataset(cfg, "train")
    assert isinstance(ds, CellposeDataset if data_type == "cellpose" else MoNuSegDataset)
    ours, ref = build.build_dataloader(cfg, "train"), jax_build.build_dataloader(jcfg, "train")
    a, b = iter(ours), iter(ref)
    for _ in range(3):
        x, y = next(a), next(b)
        assert set(x) == set(y)
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])
    ours.close()
    ref.close()
