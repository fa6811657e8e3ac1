"""BENCHMARK.json holds to the benchmark's contract, and every file it
names is there."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert line(metric["layer"])
        assert (ROOT / "portbench" / "layers" / f"{metric['name']}.py").is_file()
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert all(c in CELLS for c in metric.get("workloads", CELLS))


def reports(cell: str) -> set:
    return {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_of_its_cells_reports(metric):
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric.get("workloads", CELLS):
        assert metric["moves"] in reports(cell)


def test_layer_names_are_one_spelling_each():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and line(cell["why"])
    assert NAME.match(cell["traffic"]) and cell["config"] in [c["name"] for c in BENCH["configs"]]
    assert "setup_s" in reports(cell["name"]) and len(reports(cell["name"])) >= 2
    assert any(cell["name"] in m.get("workloads", CELLS) for m in BENCH["per_layer"])
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "portbench" / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell['name']}.json").read_text())
    assert all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


def test_pairs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert line(config["source"]) and line(config["why"])
    assert config["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
    widths = re.compile(r"(_dim|_rank|channels|hidden|intermediate|heads|width)$")
    assert not any(widths.search(k) for k in config["reduced"])
    assert any(config["name"] == w["config"] for w in BENCH["workloads"])
    assert "model" in cfg and "data" in cfg
