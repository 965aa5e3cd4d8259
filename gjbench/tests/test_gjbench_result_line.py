"""The result line ``run.main`` prints: its keys, the metrics of the
cell, and the numbers compared last, on both streams."""

import json

import pytest
import torch

from gjbench import bench, run
from gjbench.tests.conftest import SMALL


@pytest.mark.parametrize("name", [w["name"] for w in
                                  bench.spec()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(monkeypatch, capsys, name, trace):
    real = run.drive
    cell = bench.cell(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "power_line", lambda: "no card")
    # other test files may have loaded JAX into this worker; a fresh
    # process is checked in test_gjbench_isolation.py
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    monkeypatch.setattr(run, "drive", lambda c, s, sec, tr, dev, t0: real(
        c, s, 0.2, tr, "cpu", t0, sizes=SMALL[cell.config["name"]]))
    assert run.main(["--workload", name, "--seed", str(2**31 + 3),
                     "--seconds", "0.2", "--trace", str(trace)]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks" and "units" not in line
    assert line["correct"] is True and line["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    # on the CPU the device's metrics have nothing to read
    cpu = {"peak_gb", "expand_many_roofline", "mul_segsum_roofline",
           "idle_share.rows", "idle_share.aggs"}
    assert set(line["metrics"]) == {m.name for m in want} - cpu
    for m in want:
        if m.name in line["metrics"]:
            assert line["metrics"][m.name]["unit"] == m.unit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == \
        [f"check {k}" for k in line["checks"]]
