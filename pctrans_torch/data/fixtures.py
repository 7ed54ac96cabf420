"""On-disk fixture trees in the reference data layouts (the port's copy of
``pctrans_tpu/data/fixtures.py``, held equal to it by
``tests/test_torch_fixtures.py``).

The real datasets cannot ship with the repo, so these generators write
synthetic content in the *formats* the reference loaders consume; the port's
readers (``data/cvppp.py``, ``data/bbbc.py``) and ``scripts/main_torch.py`` /
``scripts/eval_torch.py`` with ``DATASET.DATA_TYPE CVPPP``/``BBBC`` run over
them unmodified.  PIL is imported when a file is written, never at import.

CVPPP A1 layout (reference connectomics/data/dataset/dataset_CVPPP.py:
56-119):

    <root>/train/plantXXX_rgb.png     RGBA (the loader .convert('RGB')s)
    <root>/train/plantXXX_label.png   uint8 instance ids, 0 = background
    <root>/train/plantXXX_fg.png      uint8 {0, 255} foreground mask
    <root>/val/...                    names from the hardcoded 20-plant
                                      val list (dataset_CVPPP.py:67-69)
    <root>/test/...                   rgb + fg only (no labels published)

The loader sorts by ``int(name[5:8])`` so plant ids are always 3 digits.

EM volume layout (the port's own, for ``DATASET.DATA_TYPE volume`` / ``tile``;
the JAX package has no writer for it):

    <root>/im/0000.png ...                u8 image stack, one PNG per section
    <root>/seg.tif                        u16 instance labels, one multi-page
                                          TIFF (a PNG stack reads back as u8)
    <root>/{im,seg}_tiles/0000/0_0.png    two tiles per section, and their
    <root>/{im,seg}.json                  JSON layouts (``create_json`` keys)

BBBC039 layout (reference dataset_BBBC.py:82-105):

    <root>/images/<name>.tif              uint16 single-channel (IXM
                                          exports are 16-bit; loaders
                                          min-max normalize)
    <root>/label_instance/<name>.png      instance-id PNG
    <root>/metadata/training.txt          one "<name>.png" per line
    <root>/metadata/validation.txt        (the loader strips the last 5
    <root>/metadata/test.txt               chars: ".png" + newline)
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .cvppp import VAL_PLANTS
from .synthetic import make_blob_image


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def _blob_scene(rng: np.random.RandomState, size: Tuple[int, int],
                n_instances=(4, 10), radius_px=None):
    """Instance label map + a renderable gray intensity field in [0, 1]."""
    img_f, label = make_blob_image(rng, size=size, n_instances=n_instances,
                                   radius_px=radius_px)
    intensity = np.clip(img_f.mean(axis=-1), 0.0, 1.0)
    return intensity, label


def write_cvppp_fixture(root: str, n_train: int = 4, n_val: int = 2,
                        n_test: int = 2, size: Tuple[int, int] = (530, 500),
                        seed: int = 0) -> dict:
    """Write a CVPPP-format tree; returns {split: [plant names]}.

    Val plants are drawn from the reference's hardcoded 20-plant val list —
    any other name would be silently dropped by the split filter.  Train
    plants use ids NOT on that list.  Test images ship rgb + fg only, like
    the real A1 test release.
    """
    rng = np.random.RandomState(seed)
    val_names = list(VAL_PLANTS[:n_val])
    taken = set(int(p[5:8]) for p in VAL_PLANTS)
    train_ids = [i for i in range(1, 200) if i not in taken][:n_train]
    train_names = [f"plant{i:03d}" for i in train_ids]
    test_names = [f"plant{i:03d}" for i in range(900, 900 + n_test)]

    out = {"train": train_names, "val": val_names, "test": test_names}
    for split, names in out.items():
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for name in names:
            gray, label = _blob_scene(rng, size)
            rgb = np.stack([np.clip(gray * s, 0, 1)
                            for s in (0.4, 0.9, 0.3)], axis=-1)
            rgba = np.concatenate(
                [np.round(rgb * 255).astype(np.uint8),
                 np.full(size + (1,), 255, np.uint8)], axis=-1)
            _save_png(os.path.join(d, f"{name}_rgb.png"), rgba)
            _save_png(os.path.join(d, f"{name}_fg.png"),
                      ((label > 0) * 255).astype(np.uint8))
            if split != "test":  # real A1 test labels are withheld
                _save_png(os.path.join(d, f"{name}_label.png"),
                          label.astype(np.uint8))
    return out


def write_bbbc_fixture(root: str, n_train: int = 2, n_val: int = 1,
                       n_test: int = 2, size: Tuple[int, int] = (520, 696),
                       seed: int = 0, density: float = 2.5e-4) -> dict:
    """Write a BBBC039-format tree; returns {split: [image names]}."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "label_instance"), exist_ok=True)
    os.makedirs(os.path.join(root, "metadata"), exist_ok=True)

    area = size[0] * size[1]
    n_inst = (max(2, int(area * density * 0.6)),
              max(3, int(area * density)))
    radius = (max(3.0, 0.01 * min(size)), max(6.0, 0.03 * min(size)))

    from PIL import Image

    splits = {"training": n_train, "validation": n_val, "test": n_test}
    out = {}
    idx = 0
    for split, count in splits.items():
        names: List[str] = []
        for _ in range(count):
            name = f"IXMtest_A{idx:02d}_s1_w1FIX{idx:04d}"
            idx += 1
            gray, label = _blob_scene(rng, size, n_instances=n_inst,
                                      radius_px=radius)
            u16 = np.round(200.0 + gray * 3000.0).astype(np.uint16)
            Image.fromarray(u16).save(
                os.path.join(root, "images", name + ".tif"))
            _save_png(os.path.join(root, "label_instance", name + ".png"),
                      label.astype(np.uint16 if label.max() > 255
                                   else np.uint8))
            names.append(name)
        with open(os.path.join(root, "metadata", split + ".txt"), "w") as f:
            f.writelines(n + ".png\n" for n in names)
        out[split] = names
    return out


# --------------------------------------------------------------- EM volumes
# the seeded augmented sample whose sha256 ``chip_smoke.py`` phase 17 prints:
# a volume the augmentor's crop fits, windows of EM_SAMPLE, drawn with
# RandomState(0); the sha256 under cv2 5.0.0 on the CPU
EM_SAMPLE = [8, 256, 256]
EM_CHECKSUM_SHAPE = (12, 384, 384)
EM_CHECKSUM_CV2_5 = "1c809e9849ba66b984528e1b01e0b13c950c0b503c5c129b8c554e231d227d64"


def em_volume(shape, seed: int, n_ids: int = 400):
    """A seeded EM-like volume: u16 instance labels, ``n_ids`` neurites each
    the cell of one seed in every section's Voronoi diagram (at a quarter of
    the resolution, the seeds drifting across z), and a u8 image: bright
    cells, dark membranes on the labels' boundaries, noise."""
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    d, h, w = shape
    hq, wq = -(-h // 4), -(-w // 4)
    pos = rng.rand(n_ids, 2) * (hq, wq)
    drift = 0.5 * rng.randn(n_ids, 2)
    label = np.empty(shape, np.uint16)
    for z in range(d):
        p = np.clip(pos + drift * z, 0, (hq - 1, wq - 1)).astype(np.int64)
        seeds = np.zeros((hq, wq), np.int32)
        seeds[p[:, 0], p[:, 1]] = np.arange(1, n_ids + 1)
        _, (iy, ix) = ndimage.distance_transform_edt(seeds == 0, return_indices=True)
        label[z] = np.repeat(np.repeat(seeds[iy, ix], 4, 0), 4, 1)[:h, :w]
    edge = np.zeros(shape, bool)
    edge[:, 1:] |= label[:, 1:] != label[:, :-1]
    edge[:, :, 1:] |= label[:, :, 1:] != label[:, :, :-1]
    image = np.where(edge, 60.0, 190.0) + 20.0 * rng.randn(*shape)
    return np.clip(image, 0, 255).astype(np.uint8), label


def write_em_volume(root, image, label) -> None:
    """The image as a u8 PNG stack through cv2 (``im/0000.png``...), the
    labels as one u16 multi-page TIFF through PIL (``seg.tif``)."""
    import cv2
    from PIL import Image

    root = Path(root)
    (root / "im").mkdir(parents=True)
    for z in range(image.shape[0]):
        cv2.imwrite(str(root / "im" / f"{z:04d}.png"), image[z])
    pages = [Image.fromarray(s) for s in label]
    pages[0].save(root / "seg.tif", save_all=True, append_images=pages[1:])


def write_em_tiles(root, image, label, tile: int) -> dict:
    """The first ``tile`` rows of the volume as two ``tile`` x ``tile`` tiles
    per section (u8 image, u16 labels, PNG through cv2) and their JSON
    layouts (``data/volume_io.py``'s ``create_json`` keys); {"im", "seg"}:
    the layouts' file names under ``root``."""
    import cv2

    root = Path(root)
    names = {}
    for kind, vol, dtype in (("im", image, "uint8"), ("seg", label, "uint16")):
        patterns = []
        for z in range(vol.shape[0]):
            d = root / f"{kind}_tiles" / f"{z:04d}"
            d.mkdir(parents=True)
            for c in range(2):
                cv2.imwrite(str(d / f"0_{c}.png"), vol[z, :tile, c * tile:(c + 1) * tile])
            patterns.append(str(d) + "/{row}_{column}.png")
        meta = {"ndim": 1, "dtype": dtype, "image": patterns, "depth": vol.shape[0],
                "height": tile, "width": 2 * tile, "n_columns": 2, "n_rows": 1,
                "tile_size": tile, "tile_ratio": 1, "tile_st": [0, 0]}
        (root / f"{kind}.json").write_text(json.dumps(meta))
        names[kind] = f"{kind}.json"
    return names


def em_volume_opts(root, sample=EM_SAMPLE) -> List[str]:
    """Config opts over ``write_em_volume``'s layout under ``root``: DATA_TYPE
    volume, DO_2D False, INPUT_SIZE = OUTPUT_SIZE ``sample``, TARGET_OPT
    ["2"] (3-channel affinity) with WEIGHT_OPT [["1"]], the default
    augmentor."""
    return ["DATASET.DATA_TYPE", "volume", "DATASET.INPUT_PATH", f"{root}/",
            "DATASET.IMAGE_NAME", "im/*.png", "DATASET.LABEL_NAME", "seg.tif",
            "DATASET.DO_2D", "False", "MODEL.INPUT_SIZE", str(list(sample)),
            "MODEL.OUTPUT_SIZE", str(list(sample)), "MODEL.TARGET_OPT", "['2']",
            "MODEL.WEIGHT_OPT", "[['1']]"]


def write_em_checksum_volume(root, seed: int = 0) -> List[str]:
    """Writes the checksum sample's volume (``EM_CHECKSUM_SHAPE``, 40 ids)
    under ``root`` unless it is there; its config opts (``em_volume_opts``).
    The sample is ``build_volume_dataset(load_cfg(opts=...), "train")
    .__getitem__(0, rng=np.random.RandomState(seed))``."""
    if not (Path(root) / "seg.tif").exists():
        write_em_volume(root, *em_volume(EM_CHECKSUM_SHAPE, seed, n_ids=40))
    return em_volume_opts(root)


def sample_checksum(sample: dict) -> str:
    """sha256 of a sample's arrays (sorted keys; dtype, shape and bytes)."""
    h = hashlib.sha256()
    for k in sorted(sample):
        a = np.ascontiguousarray(sample[k])
        h.update(f"{k}{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()
