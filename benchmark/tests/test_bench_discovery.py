"""BENCHMARK.json against the contract's shape, and every name found by its file."""

import json
import re

import pytest

from benchmark import run

SPEC = run.read_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "-m", "benchmark.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    workload, config, driver = run.cell_files(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert workload["config"] == entry["config"] == config["name"]
    assert callable(driver.run)
    assert entry["chips"] == 1
    assert workload["limits"], "a cell compares at least one number"


def test_config_entries_match_their_files():
    for c in SPEC["configs"]:
        cfg = run.read_json(run.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert c["file"].startswith("benchmark/configs/")


def test_names_units_and_bounds():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    mod = run.load_module(run.BENCH / "metrics" / f"{metric['name']}.py", "metrics")
    assert mod.read({}) is None, "a reader that finds nothing returns nothing"


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in run.cell_metrics(SPEC, cell, False)}
            assert m["moves"] in reported, (m["name"], cell)


def test_cell_metrics_by_trace():
    e2e = {m["name"] for m in run.cell_metrics(SPEC, "vehicle_kaist", False)}
    assert e2e == {"frame_p50_ms", "frame_p95_ms", "setup_s"}
    layer = {m["name"] for m in run.cell_metrics(SPEC, "vehicle_kaist", True)}
    assert "cam_stage_ms.vehicle_kaist" in layer and "lk_roofline_pct.fleet" not in layer
    assert {m["name"] for m in run.cell_metrics(SPEC, "fleet_plwg", False)} == {
        "frames_per_s", "setup_s"}
