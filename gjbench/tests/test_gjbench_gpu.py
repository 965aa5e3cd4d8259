"""On the card: one small run of each cell through the harness, correct,
with the trace read (``pytest -m gpu gjbench/tests``)."""

import pytest

from gjbench import bench, control, run
from gjbench.tests.conftest import SMALL

CELLS = [w["name"] for w in bench.spec()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_small_traced_run_on_the_card(cuda, name):
    cell = bench.cell(name)
    out = run.drive(cell, 2**31 + 21, 0.5, True, "cuda",
                    sizes=SMALL[cell.config["name"]])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
    for m in out["metrics"].values():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_small_control_fails_on_the_card(cuda, name):
    cell = bench.cell(name)
    r = control.readings(cell, 31, "cuda", SMALL[cell.config["name"]])
    assert not any(r["program"].values())
    if cell.traffic["loop"] == "fresh_query":
        assert all(r["control"].values())
