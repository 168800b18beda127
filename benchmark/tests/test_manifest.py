"""BENCHMARK.json against the benchmark's contract, and every name it gives
resolved to a file of its own."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = harness.load_manifest()


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"] and M["paths"] == ["benchmark"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in M[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in M["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/")


def test_end_to_end_bounds():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one(cell):
    e2e = [m["name"] for m in M["end_to_end"] if _reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert [m for m in M["per_layer"] if _reported(m, cell)]


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_each_per_layer_metric_moves_one_end_to_end_metric_reported_in_its_cells(metric):
    m = next(x for x in M["per_layer"] if x["name"] == metric)
    moved = next(x for x in M["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert _reported(moved, cell)
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert (harness.HERE / "metrics" / f"{metric}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_name_resolves_to_its_files(cell):
    c = harness.resolve(M, cell)
    assert (harness.HERE / "systems" / f"{c.config['system']}.py").is_file()
    assert (harness.HERE / "loops" / f"{c.traffic['loop']}.py").is_file()
    assert c.limits, "a cell compares numbers against limits set from readings"
    assert c.config["name"] == c.workload["config"]


def test_the_manifest_is_small_and_plain_json():
    text = (harness.ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    json.loads(text)
