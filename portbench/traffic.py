"""The benchmark's traffic: one generator per kind of input, reading the
parameters of a traffic file (``portbench/traffic/<name>.json``).  Every
traffic is one fixed set of scenes (drawn from its ``scene_seed``); a run's
``--seed`` only draws their order, so that every seed does the same work.

* ``scenes``: ``count`` synthetic scenes of ``size`` held in host memory
  (leaves by default, nuclei with ``"instances": "nuclei"``), served in
  batches of ``batch`` in a closed loop, in the seed's order.
* ``a1_tree``: a CVPPP A1 tree on disk (``train/plantXXX_{rgb,label,fg}.png``)
  of ``plants`` training plants, read through the program's own loader:
  written once per checkout, then linked under the plant names in the
  seed's order.

The scene generator and the A1 writer are copies of the port's
``data/synthetic.py::make_blob_image`` / ``nuclei_scene_rule`` and
``data/fixtures.py::write_cvppp_fixture`` (the CPU tests hold them equal for
the same seed), so that a change to the program cannot move the traffic.
``make_blob_image`` computes each blob over its bounding box instead of the
whole image: the same values, pixel for pixel, in a fraction of the time.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

# the reference's hardcoded 20-plant CVPPP A1 val list; train plants avoid it
VAL_PLANTS = [
    "plant002", "plant016", "plant029", "plant037", "plant045", "plant046",
    "plant055", "plant061", "plant072", "plant080", "plant088", "plant099",
    "plant104", "plant108", "plant115", "plant127", "plant130", "plant142",
    "plant148", "plant159",
]


def numpy_seed(seed: int) -> int:
    """A ``--seed`` (any whole number) as a numpy ``RandomState`` seed."""
    return int(seed) % (2 ** 32)


def make_blob_image(rng: np.random.RandomState, size: Tuple[int, int] = (448, 448),
                    n_instances: Tuple[int, int] = (4, 12),
                    radius_px: Optional[Tuple[float, float]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(image [H, W, 3] float32, label [H, W] int32): coloured ellipses
    ("leaves", radii a fraction of the image, or with ``radius_px`` dense
    small nuclei) on a dark background, disjoint, ids consecutive."""
    H, W = size
    n = rng.randint(n_instances[0], n_instances[1] + 1)
    label = np.zeros((H, W), np.int32)
    img = rng.randn(H, W, 3).astype(np.float32) * 0.05

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    next_id = 1
    for _ in range(n):
        cy = rng.uniform(0.1 * H, 0.9 * H)
        cx = rng.uniform(0.1 * W, 0.9 * W)
        if radius_px is not None:
            ry = rng.uniform(*radius_px)
            rx = rng.uniform(*radius_px)
        else:
            ry = rng.uniform(0.04, 0.12) * H
            rx = rng.uniform(0.04, 0.12) * W
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        # every pixel of the ellipse lies within max(rx, ry) of its centre
        reach = max(rx, ry) + 2.0
        r0, r1 = max(int(cy - reach), 0), min(int(cy + reach) + 2, H)
        c0, c1 = max(int(cx - reach), 0), min(int(cx + reach) + 2, W)
        box_x, box_y = xx[r0:r1, c0:c1], yy[r0:r1, c0:c1]
        u = (box_x - cx) * ct + (box_y - cy) * st
        v = -(box_x - cx) * st + (box_y - cy) * ct
        box_label = label[r0:r1, c0:c1]
        mask = ((u / rx) ** 2 + (v / ry) ** 2 < 1.0) & (box_label == 0)
        if mask.sum() < 20:
            continue
        box_label[mask] = next_id
        color = rng.uniform(0.3, 1.0, size=3).astype(np.float32)
        img[r0:r1, c0:c1][mask] = color + rng.randn(int(mask.sum()), 3).astype(np.float32) * 0.05
        next_id += 1

    ids = np.unique(label)
    remap = np.zeros(ids.max() + 1, np.int32)
    remap[ids] = np.arange(len(ids))
    return img, remap[label]


def nuclei_scene_rule(size: Tuple[int, int]):
    """(n_instances, radius_px) of nuclei scenes at ``size``: BBBC039's
    ~50-150 nuclei per 520x696 image, of about fixed size (50-148 nuclei of
    radius 10-22 px at 520x696)."""
    area = size[0] * size[1]
    n_inst = (max(2, int(area * 1.4e-4)), max(4, int(area * 4.1e-4)))
    radius = (max(3.0, min(10.0, 0.05 * min(size))),
              max(6.0, min(22.0, 0.2 * min(size))))
    return n_inst, radius


def scene_kwargs(traffic: Dict) -> Dict:
    size = tuple(traffic["size"])
    if traffic.get("instances") == "nuclei":
        n_inst, radius = nuclei_scene_rule(size)
        return {"size": size, "n_instances": n_inst, "radius_px": radius}
    return {"size": size, "n_instances": tuple(traffic.get("instances", (4, 12)))}


def order(n: int, seed: int) -> List[int]:
    """A run's order of ``n`` scenes, drawn from its ``--seed``."""
    return np.random.RandomState(numpy_seed(seed)).permutation(n).tolist()


def make_scenes(traffic: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The ``scenes`` kind: the traffic's ``count`` scenes, in the order of
    ``seed``, each {"image" [H, W, 3] f32, "label" [H, W] int32}."""
    rng = np.random.RandomState(numpy_seed(traffic["scene_seed"]))
    kw = scene_kwargs(traffic)
    scenes = []
    for _ in range(int(traffic["count"])):
        img, lab = make_blob_image(rng, **kw)
        scenes.append({"image": img, "label": lab})
    return [scenes[i] for i in order(len(scenes), seed)]


def batch_of(scenes: List[Dict[str, np.ndarray]], k: int, batch: int) -> Dict[str, np.ndarray]:
    """Batch ``k`` of a cycle through ``scenes``."""
    picked = scenes[k * batch:(k + 1) * batch]
    return {"image": np.stack([s["image"] for s in picked]),
            "label": np.stack([s["label"] for s in picked])}


# ---------------------------------------------------------------- A1 tree
def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def _blob_scene(rng, size, n_instances=(4, 10), radius_px=None):
    """Instance label map + a renderable gray intensity field in [0, 1]."""
    img_f, label = make_blob_image(rng, size=size, n_instances=n_instances,
                                   radius_px=radius_px)
    return np.clip(img_f.mean(axis=-1), 0.0, 1.0), label


def _a1_files(gray: np.ndarray, label: np.ndarray, size, with_label: bool):
    rgb = np.stack([np.clip(gray * s, 0, 1) for s in (0.4, 0.9, 0.3)], axis=-1)
    rgba = np.concatenate([np.round(rgb * 255).astype(np.uint8),
                           np.full(tuple(size) + (1,), 255, np.uint8)], axis=-1)
    files = {"rgb": rgba, "fg": ((label > 0) * 255).astype(np.uint8)}
    if with_label:                      # real A1 test labels are withheld
        files["label"] = label.astype(np.uint8)
    return files


def write_cvppp_fixture(root: str, n_train: int = 4, n_val: int = 2, n_test: int = 2,
                        size: Tuple[int, int] = (530, 500), seed: int = 0,
                        threads: int = 1) -> Dict[str, List[str]]:
    """A CVPPP A1 tree; returns {split: [plant names]}.  Val plants come from
    the reference's 20-plant val list, train plants avoid it, test plants
    have rgb and fg only.  The scenes are drawn in order from one stream;
    ``threads`` only encodes the PNGs in parallel."""
    rng = np.random.RandomState(numpy_seed(seed))
    taken = set(int(p[5:8]) for p in VAL_PLANTS)
    train_ids = [i for i in range(1, 200) if i not in taken][:n_train]
    out = {"train": [f"plant{i:03d}" for i in train_ids],
           "val": list(VAL_PLANTS[:n_val]),
           "test": [f"plant{i:03d}" for i in range(900, 900 + n_test)]}
    jobs = []
    for split, names in out.items():
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for name in names:
            gray, label = _blob_scene(rng, size)
            for kind, arr in _a1_files(gray, label, size, split != "test").items():
                jobs.append((os.path.join(d, f"{name}_{kind}.png"), arr))
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        for f in [pool.submit(_save_png, p, a) for p, a in jobs]:
            f.result()
    return out


def a1_tree(traffic: Dict, seed: int, root: str) -> str:
    """The ``a1_tree`` kind under ``root``: the traffic's plants written
    once (``root/fixture``, by :func:`write_cvppp_fixture` from
    ``scene_seed``), then ``root/tree`` made anew of hard links that give
    plant k the fixture's plant ``order(seed)[k]``; returns the tree."""
    fixture = os.path.join(root, "fixture")
    done = os.path.join(fixture, "complete")
    if not os.path.exists(done):
        shutil.rmtree(fixture, ignore_errors=True)
        write_cvppp_fixture(fixture, n_train=int(traffic["plants"]), n_val=0, n_test=0,
                            size=tuple(traffic["size"]), seed=traffic["scene_seed"],
                            threads=int(traffic.get("threads", 8)))
        open(done, "w").close()
    names = sorted({f[:8] for f in os.listdir(os.path.join(fixture, "train"))})
    tree = os.path.join(root, "tree")
    shutil.rmtree(tree, ignore_errors=True)
    os.makedirs(os.path.join(tree, "train"))
    for name, src in zip(names, (names[i] for i in order(len(names), seed))):
        for kind in ("rgb", "label", "fg"):
            os.link(os.path.join(fixture, "train", f"{src}_{kind}.png"),
                    os.path.join(tree, "train", f"{name}_{kind}.png"))
    return tree
