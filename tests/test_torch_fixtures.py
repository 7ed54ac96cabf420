"""The port's on-disk dataset tools against the JAX package's: the fixture
trees of ``pctrans_torch/data/fixtures.py`` decode to the arrays, names and
metadata that ``pctrans_tpu/data/fixtures.py`` writes, and
``scripts/scan_dataset_torch.py`` / ``scripts/tools/compare_config_torch.py``
print the lines of ``scripts/scan_dataset.py`` /
``scripts/tools/compare_config.py`` on the same trees and YAML pairs,
without importing PyYAML."""

import contextlib
import io
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pctrans_tpu.data import fixtures as jax_fixtures
from pctrans_torch.data import fixtures

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CVPPP_YAMLS = [str(REPO / "configs" / "CVPPP" / f) for f in
               ("CVPPP-PCTrans-Base.yaml", "CVPPP-PCTrans.yaml")]
BBBC_YAMLS = [str(REPO / "configs" / "BBBC" / f) for f in
              ("BBBC-PCTrans-Base.yaml", "BBBC-PCTrans.yaml")]
CVPPP_SIZE, BBBC_SIZE = (80, 72), (64, 90)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def _decoded(path):
    if path.suffix == ".txt":
        return path.read_text()
    img = Image.open(path)
    return img.mode, np.asarray(img)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for pkg, name in ((fixtures, "port"), (jax_fixtures, "jax")):
        root = tmp_path_factory.mktemp(name)
        cvppp = pkg.write_cvppp_fixture(str(root / "cvppp"), n_train=3, n_val=2,
                                        n_test=2, size=CVPPP_SIZE, seed=3)
        bbbc = pkg.write_bbbc_fixture(str(root / "bbbc"), n_train=2, n_val=2, n_test=1,
                                      size=BBBC_SIZE, seed=4, density=1e-3)
        out[name] = (root, cvppp, bbbc)
    return out


def test_fixture_trees_match_jax(trees):
    root, cvppp, bbbc = trees["port"]
    jroot, jcvppp, jbbbc = trees["jax"]
    assert (cvppp, bbbc) == (jcvppp, jbbbc)
    files = _tree(root)
    assert files == _tree(jroot)
    assert "cvppp/test/plant900_rgb.png" in files and \
        "bbbc/metadata/validation.txt" in files
    for f in files:
        a, b = _decoded(root / f), _decoded(jroot / f)
        if isinstance(a, str):
            assert a == b, f
            continue
        assert a[0] == b[0], f
        assert a[1].dtype == b[1].dtype and a[1].shape == b[1].shape, f
        np.testing.assert_array_equal(a[1], b[1], err_msg=f)


def test_fixture_formats(trees):
    """The layouts the readers take: RGBA plants, u8 labels and {0, 255}
    foregrounds, uint16 single-channel TIFF nuclei."""
    root, cvppp, bbbc = trees["port"]
    mode, rgba = _decoded(root / "cvppp" / "train" / f"{cvppp['train'][0]}_rgb.png")
    assert mode == "RGBA" and rgba.shape == CVPPP_SIZE + (4,)
    _, fg = _decoded(root / "cvppp" / "val" / f"{cvppp['val'][0]}_fg.png")
    assert set(np.unique(fg)) <= {0, 255}
    name = bbbc["training"][0]
    mode, tif = _decoded(root / "bbbc" / "images" / f"{name}.tif")
    assert tif.dtype == np.uint16 and tif.shape == BBBC_SIZE and mode.startswith("I;16")


def _run_main(script, argv):
    """``script``'s ``main()`` in this process with ``argv``; its stdout."""
    module = runpy.run_path(str(script), run_name="script_under_test")
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [str(script)] + argv
    try:
        with contextlib.redirect_stdout(buf):
            module["main"]()
    finally:
        sys.argv = old
    return buf.getvalue()


def _scan_cases(trees):
    root = trees["port"][0]
    cvppp = ["--config-base", CVPPP_YAMLS[0], "--config-file", CVPPP_YAMLS[1]]
    bbbc = ["--config-base", BBBC_YAMLS[0], "--config-file", BBBC_YAMLS[1]]
    return [
        cvppp + ["--mode", "train", "--samples", "4", "--opts", "DATASET.DATA_TYPE",
                 "CVPPP", "DATASET.INPUT_PATH", str(root / "cvppp"), "MODEL.MAX_INSTANCES", "3"],
        cvppp + ["--mode", "val", "--opts", "DATASET.DATA_TYPE", "CVPPP",
                 "DATASET.INPUT_PATH", str(root / "cvppp")],
        bbbc + ["--mode", "val", "--opts", "DATASET.DATA_TYPE", "BBBC",
                "DATASET.INPUT_PATH", str(root / "bbbc")],
        bbbc + ["--mode", "test", "--opts", "DATASET.DATA_TYPE", "BBBC",
                "DATASET.INPUT_PATH", str(root / "bbbc")],
    ]


def test_scan_dataset_twin_prints_the_jax_lines(trees):
    for argv in _scan_cases(trees):
        ours = _run_main(REPO / "scripts" / "scan_dataset_torch.py", argv)
        ref = _run_main(REPO / "scripts" / "scan_dataset.py", argv)
        assert ours == ref, argv
        assert ours.startswith("dataset=")


def test_scan_dataset_twin_strict_fails_over_the_cap(trees):
    argv = _scan_cases(trees)[0] + ["--strict"]
    with pytest.raises(SystemExit, match="exceed MAX_INSTANCES=3"):
        _run_main(REPO / "scripts" / "scan_dataset_torch.py", argv)


COMPARE_CASES = [
    [CVPPP_YAMLS[0], CVPPP_YAMLS[1]], [BBBC_YAMLS[0], BBBC_YAMLS[1]],
    [CVPPP_YAMLS[1], BBBC_YAMLS[1]], [CVPPP_YAMLS[1], BBBC_YAMLS[1], "--raw"]]


@pytest.mark.parametrize("case", COMPARE_CASES, ids=["cvppp", "bbbc", "cross", "raw"])
def test_compare_config_twin_prints_the_jax_lines(case):
    argv = ["--config1", case[0], "--config2", case[1], *case[2:]]
    ours = _run_main(REPO / "scripts" / "tools" / "compare_config_torch.py", argv)
    ref = _run_main(REPO / "scripts" / "tools" / "compare_config.py", argv)
    assert ours == ref
    assert int(ours.rsplit(":", 1)[1]) > 0


def test_twins_run_without_pyyaml(trees):
    """Both twins in a fresh interpreter: PyYAML is never imported."""
    argv = _scan_cases(trees)[1]
    code = f"""
import runpy, sys
for script, argv in [({str(REPO / 'scripts' / 'scan_dataset_torch.py')!r}, {argv!r}),
                     ({str(REPO / 'scripts' / 'tools' / 'compare_config_torch.py')!r},
                      ["--config1", {CVPPP_YAMLS[0]!r}, "--config2", {CVPPP_YAMLS[1]!r}])]:
    sys.argv = [script] + argv
    runpy.run_path(script, run_name="__main__")
print("yaml imported:", "yaml" in sys.modules)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.rstrip().endswith("yaml imported: False")
    assert "Total number of changes:" in out.stdout
