"""BENCHMARK.json against the benchmark's contract, and every name it
gives resolving to its file."""

import json
import re

import pytest

from gjbench import bench
from gjbench.tests.conftest import ROOT

SPEC = bench.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(SPEC) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10
    assert SPEC["command"][:2] == ["python3", "gjbench/run.py"]
    assert SPEC["paths"] == ["gjbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_entries_have_only_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_text_fields():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for c in SPEC["configs"]:
        assert 1 <= len(c["source"]) <= 200
        for k in c["reduced"]:
            assert NAME.match(k)


def test_setup_is_reported_everywhere_with_its_bound():
    (setup,) = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert "workloads" not in setup and setup["bound"] == 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = bench.cell(name)
    assert cell.config["queries"][cell.traffic["query"]]
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.read)


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric_moves_a_metric_its_cells_report(metric):
    (moved,) = [m for m in SPEC["end_to_end"] if m["name"] == metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("config", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_file_states_source_cuts_and_guarantees(config):
    path = ROOT / config["file"]
    assert path.parent == ROOT / "gjbench" / "configs"
    body = json.loads(path.read_text())
    assert set(config["reduced"]) == set(body["reduced"])
    assert body["guarantees"] and body["assumed"]
    assert (ROOT / "gjbench" / "data" / f"{body['generator']}.py").exists()
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
