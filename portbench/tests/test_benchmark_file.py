"""BENCHMARK.json against the benchmark's contract: keys, names and units
of the allowed characters, every file it names present under its paths,
and every per-layer metric's cells reporting the metric it moves."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def names():
    out = [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out += [k for c in BENCH["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", names())
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(harness.HERE, "metrics", metric["name"] + ".py"))
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moved = e2e[metric["moves"]]
        for cell in metric.get("workloads", []):
            assert cell in moved.get("workloads", [cell]), (metric["name"], cell)
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]


def test_paths_and_command():
    assert BENCH["paths"] == ["portbench"]
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/") and os.path.exists(
        os.path.join(harness.ROOT, config["file"]))
    assert 1 <= len(config["source"]) <= 200 and 1 <= len(config["why"]) <= 200
    doc = harness.read_json(harness.ROOT, config["file"])
    assert doc["reduced"] == config["reduced"]
    harness.port_config(doc)  # every other key a SocialMPCConfig field


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    traffic = harness.traffic(cell["traffic"])
    assert os.path.exists(os.path.join(harness.HERE, "drivers", traffic["driver"] + ".py"))
    limits = harness.limits(cell["name"])
    assert limits, "every cell has its limits"
    e2e = harness.cell_metrics(BENCH, cell["name"], "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell["name"], "per_layer")


def test_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(names()) >= len(set(names()))
