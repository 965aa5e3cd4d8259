"""The plain reference against the program on the CPU at small sizes (the
one place that imports both), and the power of the multiset comparison."""

import numpy as np
import pytest
import torch

import repro_torch
from gjbench import bench, data
from gjbench.load import answer_gap, program_inputs
from gjbench.reference import join, rows
from gjbench.tests.conftest import SMALL

# (configuration, traffic): A1 and A2 of Last.fm, fk_B of TPC-H
CASES = [("lastfm_hetrec2k", "fresh_a1"), ("lastfm_hetrec2k", "fresh_a2"),
         ("tpch_sf1", "fresh_fk_b")]


def small(case, seed):
    cfg, traffic = bench.parts(*case)
    cfg["sizes"] = {**cfg["sizes"], **SMALL[cfg["name"]]}
    d = data.generate(cfg, seed)
    return cfg, traffic, d, cfg["queries"][traffic["query"]]


def program_rows(cfg, traffic, d):
    cat, jq = program_inputs(cfg, traffic, d)
    gj = repro_torch.GraphicalJoin(cat, jq, device="cpu")
    gfjs = gj.run()
    cols = gj.desummarize(gfjs, decode=False)
    return cols, {v: gfjs.domains[v].values for v in cols}, gfjs.join_size


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_program_rows_match_the_reference(case, seed):
    cfg, traffic, d, q = small(case, seed)
    tree = join.build(q, d.tables)
    cols, values, size = program_rows(cfg, traffic, d)
    assert size == join.count(tree) > 0
    fp, n = rows.fingerprint(cols, values, seed)
    assert n == size and fp == rows.expected(tree, seed)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1])
def test_plain_rows_equal_the_programs_as_multisets(case):
    cfg, traffic, d, q = small(case, 9)
    tree = join.build(q, d.tables)
    order = list(dict.fromkeys(v for _, b in q for v in b.values()))
    ref = rows.expand(tree, order, "cpu")
    cols, values, _ = program_rows(cfg, traffic, d)

    def table(c, vals):
        return np.unique(np.stack([vals[v][c[v].numpy()] for v in order], 1),
                         axis=0, return_counts=True)

    a, b = table(ref, tree.domains), table(cols, values)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def altered(cols, how):
    out = {v: c.clone() for v, c in cols.items()}
    v0 = sorted(out)[0]
    if how == "swap":            # two rows that differ twice swap one value
        v1 = sorted(out)[1]
        i = int(torch.nonzero((out[v0] != out[v0][0])
                              & (out[v1] != out[v1][0]))[0])
        out[v0][[0, i]] = out[v0][[i, 0]]
    elif how == "drop":
        out = {v: c[:-1] for v, c in out.items()}
    elif how == "duplicate":
        out = {v: torch.cat([c, c[:1]]) for v, c in out.items()}
    elif how == "replace":       # one row replaced by a copy of another
        out = {v: torch.cat([c[1:2], c[1:]]) for v, c in out.items()}
    return out


@pytest.mark.parametrize("how", ["swap", "drop", "duplicate", "replace"])
def test_the_fingerprint_sees_one_row_changed(how):
    cfg, traffic, d, q = small(CASES[1], 4)
    tree = join.build(q, d.tables)
    cols, values, _ = program_rows(cfg, traffic, d)
    fp, _ = rows.fingerprint(altered(cols, how), values, 4)
    assert all(a != b for a, b in zip(fp, rows.expected(tree, 4)))


def test_an_index_outside_its_values_is_refused():
    cfg, traffic, d, q = small(CASES[0], 4)
    cols, values, _ = program_rows(cfg, traffic, d)
    v = sorted(cols)[0]
    cols[v][5] = len(values[v])
    with pytest.raises(ValueError):
        rows.fingerprint(cols, values, 4)


@pytest.mark.parametrize("var", ["A2", "U1", "A1"])
def test_group_counts_match_the_programs_aggregates(var):
    cfg, traffic, d, q = small(("lastfm_hetrec2k", "aggs_a2"), 6)
    tree = join.build(q, d.tables)
    cat, jq = program_inputs(cfg, traffic, d)
    gj = repro_torch.GraphicalJoin(cat, jq, device="cpu")
    got = gj.aggregate("count", by=[var])
    assert answer_gap(got, join.group_count(tree, var)) == 0
    assert gj.aggregate("count") == join.count(tree)
