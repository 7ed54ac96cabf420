"""The copied scene generator and A1 writer give what the port's
``data/synthetic.py`` and ``data/fixtures.py`` give for the same seed."""

import os

import numpy as np
import pytest

from portbench import traffic


@pytest.mark.parametrize("size,nuclei", [((530, 500), False), ((520, 696), True),
                                         ((96, 128), True)])
def test_scenes_equal_the_ports(size, nuclei):
    from pctrans_torch.data import synthetic

    kw = traffic.scene_kwargs({"size": list(size),
                               "instances": "nuclei" if nuclei else [4, 12]})
    assert kw.get("radius_px") == (synthetic.nuclei_scene_rule(size)[1] if nuclei else None)
    for seed in (0, 2 ** 31 + 5):
        a = np.random.RandomState(traffic.numpy_seed(seed))
        b = np.random.RandomState(traffic.numpy_seed(seed))
        for _ in range(2 if nuclei and size[0] > 500 else 3):
            ia, la = traffic.make_blob_image(a, **kw)
            ib, lb = synthetic.make_blob_image(b, **kw)
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(la, lb)


def test_every_seed_gets_the_same_scenes_in_its_own_order():
    t = {"kind": "scenes", "count": 5, "size": [40, 48], "instances": [2, 4], "batch": 1,
         "scene_seed": 3}
    a, b, c = traffic.make_scenes(t, 9), traffic.make_scenes(t, 9), traffic.make_scenes(t, 10)
    assert all(np.array_equal(x["image"], y["image"]) for x, y in zip(a, b))
    key = [x["image"].tobytes() for x in a]
    assert sorted(key) == sorted(x["image"].tobytes() for x in c) and key != [
        x["image"].tobytes() for x in c]


def test_a1_tree_links_one_fixture_in_the_seeds_order(tmp_path):
    t = {"kind": "a1_tree", "plants": 4, "size": [40, 36], "threads": 2, "scene_seed": 1}
    trees = [sorted(os.listdir(traffic.a1_tree(t, seed, str(tmp_path)) + "/train"))
             for seed in (5, 6)]
    assert trees[0] == trees[1] and len(trees[0]) == 12
    inode = {seed: [os.stat(os.path.join(traffic.a1_tree(t, seed, str(tmp_path)), "train", f)).st_ino
                    for f in trees[0]] for seed in (5, 6, 5)}
    fixture = sorted(os.stat(os.path.join(tmp_path, "fixture", "train", f)).st_ino
                     for f in trees[0])
    assert sorted(inode[5]) == fixture and inode[5] != inode[6]


def test_a1_tree_equals_the_ports(tmp_path):
    from PIL import Image

    from pctrans_torch.data import fixtures

    mine = traffic.write_cvppp_fixture(str(tmp_path / "a"), n_train=3, n_val=1, n_test=1,
                                       size=(60, 50), seed=4, threads=3)
    port = fixtures.write_cvppp_fixture(str(tmp_path / "b"), n_train=3, n_val=1, n_test=1,
                                        size=(60, 50), seed=4)
    assert mine == port
    for split in ("train", "val", "test"):
        files = sorted(os.listdir(tmp_path / "a" / split))
        assert files == sorted(os.listdir(tmp_path / "b" / split))
        for f in files:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a" / split / f)),
                                          np.asarray(Image.open(tmp_path / "b" / split / f)))
