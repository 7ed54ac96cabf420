"""The benchmark's CPU tests: ``python -m pytest portbench/tests``."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))             # tiny.py
sys.path.insert(0, str(HERE.parents[1]))  # the checkout's root: portbench, pctrans_torch

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def build_dir(tmp_path, monkeypatch):
    """Trees, outputs and counts of a test go to its own directory."""
    from portbench import bench

    monkeypatch.setattr(bench, "BUILD", tmp_path / "build")
    return tmp_path / "build"
