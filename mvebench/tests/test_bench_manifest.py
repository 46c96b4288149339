"""BENCHMARK.json against the contract's rules on names and fields, and
every entry resolved to its file by name."""

import json
import re

import pytest

from mvebench.harness import bench

MANIFEST = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["mvebench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for e in MANIFEST["configs"] + MANIFEST["workloads"] + METRICS]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    data = json.loads((bench.ROOT / cfg["file"]).read_text())
    assert cfg["file"] == f"mvebench/configs/{cfg['name']}.json"
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    workload = bench.load_json(bench.HERE / "workloads" / f"{cell['name']}.json")
    assert (bench.HERE / "drivers" / f"{workload['driver']}.py").is_file()
    assert cell["chips"] in (1, 4)
    e2e = [m["name"] for m in MANIFEST["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in e2e and workload["rate_metric"] in e2e
    layers = [m for m in MANIFEST["per_layer"] if cell["name"] in m.get("workloads", [])]
    assert layers and all(m["moves"] in e2e for m in layers)
    assert workload["limits"] and all(v >= 0 for v in workload["limits"].values())


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_reader_declares_its_metric(metric):
    reader = bench.load_module("metrics", metric["name"])
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (metric["unit"], metric["layer"],
                                                          metric["moves"])
    assert callable(reader.read)
