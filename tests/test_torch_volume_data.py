"""The port's volume data modules (``pctrans_torch/data/{seg_targets,
diffusion,volume_io,volume_augment,volume_dataset}.py``, copies of the JAX
package's) against the JAX package's on the same seeded inputs, and
``get_dataset`` with DATA_TYPE volume / tile against JAX's: equal arrays,
dtypes and shapes."""

import json
from pathlib import Path

import numpy as np
import pytest

from pctrans_torch import config
from pctrans_torch.data import (build, diffusion, fixtures, seg_targets, volume_augment,
                                volume_io)
from pctrans_tpu.config import load_cfg as jax_load_cfg
from pctrans_tpu.data import build as jax_build
from pctrans_tpu.data import diffusion as jax_diffusion
from pctrans_tpu.data import seg_targets as jax_seg_targets
from pctrans_tpu.data import volume_augment as jax_volume_augment
from pctrans_tpu.data import volume_io as jax_volume_io



def assert_same(a, b):
    """Equal nested outputs: arrays of one dtype and shape, equal values."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _labels(shape=(4, 24, 24), seed=0, n=6):
    """Seeded instance labels: ``n`` boxes of ids 1..n over a background."""
    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.int64)
    for i in range(1, n + 1):
        y, x = rng.randint(0, shape[-2] - 8), rng.randint(0, shape[-1] - 8)
        lab[..., y:y + rng.randint(4, 9), x:x + rng.randint(4, 9)] = i
    return lab


# ----------------------------------------------------------- seg_targets
TARGETS = ["0", "1", "2", "3-10-1-0", "4-1-0", "4-2-1", "5", "5-3d-1-0-2.0", "6",
           "6-3d-8-50", "7", "7-0", "8", "9"]


@pytest.mark.parametrize("topt", TARGETS)
def test_seg_to_targets_equals_jax(topt):
    """Every TARGET_OPT code 0-9, on a 3D label map and, with erosion and
    dilation, on a 2D one (where JAX's code takes only 3D, both raise
    alike)."""
    lab = _labels()
    assert_same(seg_targets.seg_to_targets(lab, [topt]),
                jax_seg_targets.seg_to_targets(lab, [topt]))
    lab2 = _labels((24, 24), seed=1)
    kw = dict(erosion_rates=[1], dilation_rates=[1])
    try:
        ref = jax_seg_targets.seg_to_targets(lab2, [topt], **kw)
    except Exception as e:          # noqa: BLE001  (the same failure either way)
        with pytest.raises(type(e)):
            seg_targets.seg_to_targets(lab2, [topt], **kw)
    else:
        assert_same(seg_targets.seg_to_targets(lab2, [topt], **kw), ref)


@pytest.mark.parametrize("wopt", [["0"], ["1"], ["1-1"], ["2-10-5"], ["0", "1"]])
def test_seg_to_weights_equals_jax(wopt):
    lab = _labels()
    targets = seg_targets.seg_to_targets(lab, ["0"])
    mask = (np.random.RandomState(2).rand(*lab.shape) > 0.2).astype(np.float32)
    for m in (None, mask):
        assert_same(seg_targets.seg_to_weights(targets, [wopt], mask=m, seg=lab),
                    jax_seg_targets.seg_to_weights(targets, [wopt], mask=m, seg=lab))


@pytest.mark.parametrize("mode", ["gaussian", "bump"])
def test_blending_matrices_equal_jax(mode):
    for sz in ((8, 16, 16), (3, 17, 12)):
        assert_same(seg_targets.build_blending_matrix(sz, mode),
                    jax_seg_targets.build_blending_matrix(sz, mode))


# ------------------------------------------------------------- diffusion
def test_diffusion_flows_equal_jax():
    lab2 = _labels((20, 22), seed=3).astype(np.int32)
    assert_same(diffusion.masks2flows(lab2), jax_diffusion.masks2flows(lab2))
    lab3 = _labels((3, 20, 22), seed=4)
    assert_same(diffusion.seg2diffgrads(lab3), jax_diffusion.seg2diffgrads(lab3))


# ------------------------------------------------------------- volume_io
def test_readvol_equals_jax(tmp_path):
    """A u8 PNG stack through cv2, a u16 PNG stack (read as u8: JAX's
    ``readimgs`` stores u8), a u16 multi-page TIFF through PIL and an HDF5
    file, each read by both packages."""
    import cv2
    import h5py
    from PIL import Image

    rng = np.random.RandomState(5)
    u8 = rng.randint(0, 256, (3, 10, 12)).astype(np.uint8)
    u16 = rng.randint(0, 65536, (3, 10, 12)).astype(np.uint16)
    for name, vol in (("u8", u8), ("u16", u16)):
        (tmp_path / name).mkdir()
        for z in range(3):
            cv2.imwrite(str(tmp_path / name / f"{z}.png"), vol[z])
    pages = [Image.fromarray(s) for s in u16]
    pages[0].save(tmp_path / "seg.tif", save_all=True, append_images=pages[1:])
    with h5py.File(tmp_path / "v.h5", "w") as f:
        f.create_dataset("main", data=u16)
    for path, expect in ((f"{tmp_path}/u8/*.png", u8), (f"{tmp_path}/u16/*.png", None),
                         (f"{tmp_path}/seg.tif", u16), (f"{tmp_path}/v.h5", u16)):
        ours = volume_io.readvol(path)
        assert_same(ours, jax_volume_io.readvol(path))
        if expect is not None:
            assert_same(ours, expect)
    assert volume_io.readvol(f"{tmp_path}/u16/*.png").dtype == np.uint8


def test_savevol_tile2volume_and_vast2seg_equal_jax(tmp_path):
    rng = np.random.RandomState(6)
    vol = rng.randint(0, 256, (2, 16, 16)).astype(np.uint8)
    for pkg, name in ((volume_io, "ours"), (jax_volume_io, "jax")):
        pkg.savevol(str(tmp_path / f"{name}.h5"), vol)
        pkg.savevol(str(tmp_path / name), vol, format="png")
    assert_same(volume_io.readvol(str(tmp_path / "ours.h5")),
                jax_volume_io.readvol(str(tmp_path / "jax.h5")))
    assert_same(volume_io.readvol(str(tmp_path / "ours" / "*.png")),
                jax_volume_io.readvol(str(tmp_path / "jax" / "*.png")))
    rgb = rng.randint(0, 256, (5, 6, 3)).astype(np.uint8)
    assert_same(volume_io.vast2Seg(rgb), jax_volume_io.vast2Seg(rgb))
    # two 8x8 tiles of an RGB-coded label section and a grey image section
    import cv2

    patterns = {}
    for kind in ("im", "seg"):
        d = tmp_path / kind
        d.mkdir()
        for c in range(2):
            tile = (rng.randint(0, 256, (8, 8, 3)) if kind == "seg"
                    else rng.randint(0, 256, (8, 8))).astype(np.uint8)
            cv2.imwrite(str(d / f"0_{c}.png"), tile)
        patterns[kind] = [str(d) + "/{row}_{column}.png"]
    for coord, kind, ratio in (([0, 1, 0, 8, 0, 16], "im", 1), ([0, 1, -2, 10, 3, 18], "im", 1),
                               ([0, 1, 0, 8, 0, 16], "seg", 1), ([0, 1, 0, 8, 0, 16], "im", 2)):
        kw = dict(tile_sz=8, tile_ratio=ratio, do_im=kind == "im",
                  dt=np.uint8 if kind == "im" else np.uint32)
        assert_same(volume_io.tile2volume(patterns[kind], coord, [0, 1, 0, 8, 0, 16], **kw),
                    jax_volume_io.tile2volume(patterns[kind], coord, [0, 1, 0, 8, 0, 16],
                                              **kw))


# -------------------------------------------------------- volume_augment
KW = {"additional_targets": {"label": "mask"}}
AUGMENTORS = {
    "Flip": lambda m: m.Flip(p=1.0, **KW),
    "Rotate90": lambda m: m.Rotate(p=1.0, rot90=True, **KW),
    "Rotate": lambda m: m.Rotate(p=1.0, rot90=False, **KW),
    "Rescale": lambda m: m.Rescale(p=1.0, **KW),
    "Elastic": lambda m: m.Elastic(p=1.0, alpha=8.0, sigma=4.0, **KW),
    "Grayscale": lambda m: m.Grayscale(p=1.0, **KW),
    "MisAlignment": lambda m: m.MisAlignment(p=1.0, displacement=8, **KW),
    "MissingSection": lambda m: m.MissingSection(p=1.0, **KW),
    "MissingParts": lambda m: m.MissingParts(p=1.0, iterations=8, **KW),
    "MotionBlur": lambda m: m.MotionBlur(p=1.0, kernel_size=5, **KW),
    "CutBlur": lambda m: m.CutBlur(p=1.0, **KW),
    "CutNoise": lambda m: m.CutNoise(p=1.0, **KW),
    "CopyPaste": lambda m: m.CopyPasteAugmentor(p=1.0, **KW),
}


def _sample(seed=0):
    rs = np.random.RandomState(seed)
    img = rs.rand(8, 48, 48).astype(np.float32)
    lbl = _labels((8, 48, 48), seed=seed, n=5).astype(np.float32)
    return {"image": img, "label": lbl}


@pytest.mark.parametrize("name", list(AUGMENTORS))
def test_augmentor_equals_jax(name):
    """Each augmentation on the same sample and RandomState, three seeds
    (MisAlignment's rotate and translate branches both run)."""
    for seed in range(3):
        outs = [AUGMENTORS[name](m)(_sample(seed), np.random.RandomState(seed))
                for m in (volume_augment, jax_volume_augment)]
        assert_same(*outs)


def test_mixup_equals_jax():
    vol = np.random.RandomState(7).rand(4, 1, 8, 16, 16).astype(np.float32)
    assert_same(volume_augment.MixupAugmentor()(vol.copy(), np.random.RandomState(0)),
                jax_volume_augment.MixupAugmentor()(vol.copy(), np.random.RandomState(0)))


def test_build_train_augmentor_equals_jax():
    """The config's augmentor (every AUGMENTOR block on, smoothing on): the
    same inflated sample size and the same composed output."""
    opts = ["MODEL.INPUT_SIZE", "[8, 32, 32]", "AUGMENTOR.SMOOTH", "True"]
    for block in ("MOTIONBLUR", "CUTBLUR", "CUTNOISE", "COPYPASTE"):
        opts += [f"AUGMENTOR.{block}.ENABLED", "True"]
    ours = volume_augment.build_train_augmentor(config.load_cfg(opts=opts))
    ref = jax_volume_augment.build_train_augmentor(jax_load_cfg(opts=opts))
    assert_same(ours.sample_size, ref.sample_size)
    shape = tuple(int(s) for s in ours.sample_size)
    for seed in range(2):
        rs = np.random.RandomState(seed)
        sample = {"image": rs.rand(*shape).astype(np.float32),
                  "label": _labels(shape, seed=seed, n=8).astype(np.float32)}
        assert_same(ours({k: v.copy() for k, v in sample.items()}, np.random.RandomState(seed)),
                    ref({k: v.copy() for k, v in sample.items()}, np.random.RandomState(seed)))


# ------------------------------------------------------------ get_dataset
VOLUME = (12, 192, 192)


def _write_volume(root: Path):
    """Phase 17's layout at a small size: the image a u8 PNG stack, the
    labels a u16 multi-page TIFF; plus two-tile JSON layouts of its rows."""
    image, label = fixtures.em_volume(VOLUME, 0, n_ids=30)
    fixtures.write_em_volume(root, image, label)
    return fixtures.write_em_tiles(root, image, label, 96)


def _cfgs(root: Path, data_type: str, names):
    opts = ["DATASET.DATA_TYPE", "volume", "DATASET.INPUT_PATH", f"{root}/",
            "DATASET.DO_2D", "False", "MODEL.INPUT_SIZE", "[4, 32, 32]",
            "MODEL.OUTPUT_SIZE", "[4, 32, 32]", "MODEL.TARGET_OPT", "['2', '0']",
            "MODEL.WEIGHT_OPT", "[['1'], ['0']]", "INFERENCE.STRIDE", "[2, 16, 16]",
            "SOLVER.ITERATION_TOTAL", "3"]
    if data_type == "tile":
        opts += ["DATASET.DO_CHUNK_TITLE", "1", "DATASET.IMAGE_NAME", names["im"],
                 "DATASET.LABEL_NAME", names["seg"], "DATASET.DATA_CHUNK_NUM", "[1, 1, 2]",
                 "DATASET.DATA_CHUNK_ITER", "4"]
    else:
        opts += ["DATASET.IMAGE_NAME", "im/*.png", "DATASET.LABEL_NAME", "seg.tif"]
    return config.load_cfg(opts=opts), jax_load_cfg(opts=opts)


@pytest.fixture(scope="module")
def volume_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("volume")
    return root, _write_volume(root)


def _items(ds, mode):
    """Train: three seeded draws; val/test: the first, a middle and the last
    window; a TileDataset's over each of its chunks."""
    def draw(d):
        if mode == "train":
            return [d.__getitem__(i, rng=np.random.RandomState(i)) for i in range(3)]
        return [d[i] for i in (0, len(d) // 2, len(d) - 1)]

    if hasattr(ds, "updatechunk"):
        out = []
        for _ in range(len(ds)):
            ds.updatechunk()
            out.append((ds.get_coord_name(), len(ds.dataset), draw(ds.dataset)))
        return out
    return len(ds), draw(ds)


@pytest.mark.parametrize("data_type", ["volume", "tile"])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_get_dataset_equals_jax(volume_root, data_type, mode):
    """Samples, affinity and binary targets and their weights (train), the
    val/test grids' windows, and a TileDataset's chunks, as JAX gives them."""
    root, names = volume_root
    ours, ref = _cfgs(root, data_type, names)
    ds = build.get_dataset(ours, mode)
    assert type(ds).__name__ == ("TileDataset" if data_type == "tile" else "VolumeDataset")
    assert_same(_items(ds, mode), _items(jax_build.get_dataset(ref, mode), mode))


def test_phase17_checksum_sample_equals_jax_and_the_recorded_one(tmp_path):
    """``chip_smoke.py`` phase 17's seeded augmented sample: the port's and
    the JAX package's equal, and under cv2 5.0 its sha256 is the one the
    phase prints beside the card's."""
    import cv2

    opts = fixtures.write_em_checksum_volume(tmp_path)
    ours, ref = (b.build_volume_dataset(load(opts=opts), "train").__getitem__(
        0, rng=np.random.RandomState(0))
        for b, load in ((build, config.load_cfg), (jax_build, jax_load_cfg)))
    assert_same(ours, ref)
    assert sorted(ours) == ["image", "target_0", "weight_0_0"]
    assert ours["target_0"].shape == (3, *fixtures.EM_SAMPLE)
    if cv2.__version__.startswith("5.0."):
        assert fixtures.sample_checksum(ours) == fixtures.EM_CHECKSUM_CV2_5


def test_tile_layout_json_is_create_json_s(volume_root):
    root, names = volume_root
    meta = json.loads((root / names["im"]).read_text())
    ref = volume_io.create_json(depth=meta["depth"], height=meta["height"],
                                width=meta["width"], n_columns=2, n_rows=1,
                                tile_size=meta["tile_size"])
    assert sorted(meta) == sorted(ref)
