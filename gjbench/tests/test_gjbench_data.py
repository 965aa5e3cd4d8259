"""The frozen generators keep their sources' sizes and rules."""

import numpy as np
import pytest

from gjbench import bench, data
from gjbench.reference import join

LASTFM = bench.cell("lastfm.a2_rows").config
TPCH = bench.cell("tpch_sf1.fk_rows").config


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_lastfm_rows_and_join_sizes(seed):
    d = data.generate(LASTFM, seed)
    ua = d.tables["user_artists"]
    # the published row count, 49 or 50 distinct artists a user
    assert d.rows("user_artists") == 92_834
    pairs = np.unique(np.stack([ua["userID"], ua["artistID"]]), axis=1)
    assert pairs.shape[1] == 92_834
    per_user = np.unique(ua["userID"], return_counts=True)[1]
    assert len(per_user) == 1_892 and set(per_user) == {49, 50}
    assert d.rows("user_friends") == 26_306
    sizes = {q: join.count(join.build(LASTFM["queries"][q], d.tables))
             for q in ("lastfm_A1", "lastfm_A2")}
    assert sizes == {"lastfm_A1": 63_339_184, "lastfm_A2": 1_224_405_138}


def test_lastfm_seeds_relabel_the_same_structure():
    a, b = data.generate(LASTFM, 1), data.generate(LASTFM, 2)
    ua_a = a.tables["user_artists"]
    assert not np.array_equal(ua_a["userID"], b.tables["user_artists"]
                              ["userID"])
    # relabelled one to one: every table's degrees are the same multiset
    for table, cols in a.tables.items():
        for col, x in cols.items():
            y = b.tables[table][col]
            assert np.array_equal(np.sort(np.unique(x, return_counts=True)[1]),
                                  np.sort(np.unique(y, return_counts=True)[1]))


@pytest.mark.parametrize("seed", [0, 4_294_967_311])
def test_tpch_population_rules(seed):
    d = data.generate(TPCH, seed)
    c, o, li = (d.tables[t] for t in ("customer", "orders", "lineitem"))
    assert len(c["c_custkey"]) == 150_000 and len(o["o_orderkey"]) == 1_500_000
    assert np.all((o["o_custkey"] % 3) != 0)
    assert set(np.unique(c["c_nationkey"])) == set(range(25))
    keys, per = np.unique(li["l_orderkey"], return_counts=True)
    assert np.array_equal(keys, np.sort(o["o_orderkey"]))
    assert per.min() == 1 and per.max() == 7
    # data seed 0 draws 6,001,189 lines; every run seed relabels them
    assert len(li["l_orderkey"]) == 6_001_189
    assert li["l_partkey"].min() >= 1 and li["l_partkey"].max() <= 200_000
    # sparse keys: the first 8 of every 32
    assert np.all((o["o_orderkey"] - 1) % 32 < 8)
