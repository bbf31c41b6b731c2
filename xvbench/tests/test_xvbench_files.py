"""Every file the harness finds by name loads, every name and unit keeps to
the benchmark's characters, and BENCHMARK.json agrees with the files."""

import glob
import json
import os
import re

import pytest

from xvbench import harness

HERE = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names(sub, ext):
    return sorted(os.path.basename(p)[:-len(ext)]
                  for p in glob.glob(os.path.join(HERE, sub, "*" + ext)))


def _benchmark():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", _names("workloads", ".json"))
def test_cell_files_load(cell):
    spec, config, traffic, driver, flops = harness.cell_files(cell)
    assert NAME.match(cell) and NAME.match(spec["config"]) and NAME.match(spec["traffic"])
    assert spec["chips"] in (1, 4)
    assert hasattr(driver, "Driver") and hasattr(flops, "train_step") and hasattr(flops, "forward")
    assert spec["limits"] and all(NAME.match(k) for k in spec["limits"])
    assert all(NAME.match(k) for k in config.get("reduced", []))


@pytest.mark.parametrize("name", _names("metrics", ".py"))
def test_metric_files_load(name):
    reader = harness.metric_readers()[name]
    assert NAME.match(name) and UNIT.match(reader.UNIT)
    assert reader.read({"driver": "none"}) is None  # nothing to read: no value


def test_benchmark_agrees_with_the_files():
    bench = _benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "xvbench/run.py"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("xvbench/configs/")
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    assert len(metrics) == len(bench["end_to_end"]) + len(bench["per_layer"])
    assert all(NAME.match(n) and UNIT.match(m["unit"]) for n, m in metrics.items())
    readers = harness.metric_readers()
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for w in bench["workloads"]:
        spec = harness.load_json("workloads", w["name"] + ".json")
        assert (w["config"], w["traffic"], w["chips"]) == (spec["config"], spec["traffic"],
                                                          spec["chips"])
        assert w["config"] in configs and len(w["why"]) <= 200
        assert "setup_s" in {e["name"] for e in bench["end_to_end"]}
    assert len(json.dumps(bench)) < 64 * 1024


def test_benchmark_command_files_stay_under_paths():
    bench = _benchmark()
    for path in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", path) and not path.startswith("/")
        assert ".." not in path.split("/")
    assert bench["command"][1].startswith(tuple(p + "/" for p in bench["paths"]))
