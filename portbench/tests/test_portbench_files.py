"""BENCHMARK.json and the files it names: present, parsed, consistent, and
within the limits of the benchmark's format."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [e["name"] for e in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


def test_every_metric_lists_cells_that_report_its_end_to_end_metric():
    cells = {w["name"] for w in BENCH["workloads"]}
    reported = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    assert "setup_s" in reported and reported["setup_s"] == cells
    for m in METRICS:
        if m["name"] == "setup_s":
            # every cell reports set-up, later ones too, so it names none
            assert "workloads" not in m
        else:
            assert m["workloads"] and set(m["workloads"]) <= cells
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= reported[m["moves"]], m["name"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in cells:
        assert sum(cell in r for r in reported.values()) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_each_layer_is_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert (spec.HERE / "systems" / f"{cfg['system']}.py").is_file()
    yardstick = cfg.get("yardstick", spec.DEFAULT_YARDSTICK)
    assert (spec.HERE / "yardsticks" / f"{yardstick}.py").is_file()
    assert entry["file"].startswith("portbench/configs/")


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_file(entry):
    cell = spec.load_cell(entry["name"])
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] == 1 and cell.workload["why"] == entry["why"]
    assert len(entry["why"]) <= 200
    assert (spec.HERE / "traffic" / f"{cell.kind}.py").is_file()
    limits = cell.workload["limits"]  # an exact comparison has the limit 0
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
    if cell.yardstick == spec.DEFAULT_YARDSTICK:
        assert cell.workload["control"] in ("tf32", "fp8")
        assert set(limits) == {"err"} and 0 < limits["err"] < 1


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader(m):
    folder = "end_to_end" if m in BENCH["end_to_end"] else "layer_metrics"
    assert callable(spec.load_module(folder, m["name"]).read)


def test_benchmark_lists_exactly_the_files():
    listed = {
        "configs": {spec.ROOT / c["file"] for c in BENCH["configs"]},
        "workloads": {spec.HERE / "workloads" / f"{w['name']}.json" for w in BENCH["workloads"]},
        "end_to_end": {spec.HERE / "end_to_end" / f"{m['name']}.py" for m in BENCH["end_to_end"]},
        "layer_metrics": {spec.HERE / "layer_metrics" / f"{m['name']}.py" for m in BENCH["per_layer"]},
    }
    for folder, want in listed.items():
        have = set((spec.HERE / folder).glob("*.json" if folder in ("configs", "workloads") else "*.py"))
        assert have == want, folder
