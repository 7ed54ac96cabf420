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

import os
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
