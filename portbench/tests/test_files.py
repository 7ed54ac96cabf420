"""Every cell, configuration, traffic mix, entry and per-layer metric of
BENCHMARK.json is a file found by its name, and the manifest keeps to the
benchmark's contract on names, units, keys and sizes."""

import json
import re

import pytest

from portbench import bench

B = bench.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_manifest_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"] and B["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len((bench.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in B[group]:
            names.append(item["name"])
            assert NAME.match(item["name"]), item["name"]
            for key in ("why", "layer", "source"):
                if key in item:
                    assert 1 <= len(item[key]) <= 200 and "\n" not in item[key]
            if "unit" in item:
                assert UNIT.match(item["unit"]), item["unit"]
                assert item["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    c = bench.load_cell(cell)
    assert c.workload["name"] == cell and c.config["name"] == c.workload["config"]
    assert (bench.HERE / "entries" / f"{c.workload['entry']}.py").is_file()
    for path in c.config["yaml"]:
        assert (bench.REPO / path).is_file() and path.startswith("portbench/")
    assert c.config["reduced"] == [] and c.traffic["kind"] in ("scenes", "a1_tree")
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer and all(m["moves"] in reported for m in c.per_layer)


@pytest.mark.parametrize("name", [m["name"] for m in B["per_layer"]])
def test_metric_reader_loads_by_name(name):
    reader = bench.load_module("metrics", name)
    assert callable(reader.read)


@pytest.mark.parametrize("config", B["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_one_named(config):
    data = json.loads((bench.REPO / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in B["workloads"])
