"""The control, the plain reference in the program's place with one
guarantee broken, comes out not correct where the program's run comes
out correct."""

import pytest

from gjbench import bench, control, data
from gjbench.load import agg_checks
from gjbench.reference import join
from gjbench.tests.conftest import SMALL

ROWS = [w["name"] for w in bench.spec()["workloads"]
        if bench.cell(w["name"]).traffic["loop"] == "fresh_query"]


def failing(checks):
    return [k for k, v in checks.items() if v > 0]


@pytest.mark.parametrize("name", ROWS)
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_rows_control_loses_a_row_and_fails(name, seed):
    cell = bench.cell(name)
    r = control.readings(cell, seed, "cpu", SMALL[cell.config["name"]])
    assert not failing(r["program"])
    assert failing(r["control"]) == ["row_count_gap", "row_multiset_gap"]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_aggs_control_in_float32_fails_at_the_cells_size(seed):
    # the reference's answers need only the tables, so the control runs at
    # the cell's own size here: A2's counts pass 2^24
    cell = bench.cell("lastfm.a2_aggs")
    d = data.generate(cell.config, seed)
    tree = join.build(cell.config["queries"]["lastfm_A2"], d.tables)

    def answers(ring):
        out = {"count": join.count(tree, ring=ring)}
        for k in cell.traffic["kinds"]:
            if k.get("by"):
                out[k["name"]] = join.group_count(tree, k["by"][0], ring=ring)
        return out

    exact = answers("count")
    checks = {k: v for k, (v, _) in
              agg_checks(list(answers("f32").items()), exact).items()}
    assert checks["answers_wrong"] >= 1 and checks["count_gap"] >= 1
    assert agg_checks(list(exact.items()), exact)["answers_wrong"][0] == 0


def test_aggs_program_reading_at_small_size_is_exact():
    cell = bench.cell("lastfm.a2_aggs")
    r = control.readings(cell, 5, "cpu", SMALL[cell.config["name"]])
    assert not failing(r["program"])
