"""The command fails without a card, and without the program."""

import shutil
import subprocess
import sys

from portbench import bench


def test_missing_card_exits_2_with_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "cvppp.eval",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=bench.REPO, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == "" and "needs 1 CUDA card" in out.stderr


def test_alone_in_a_directory_it_fails(tmp_path):
    shutil.copy(bench.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "bbbc.eval",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
