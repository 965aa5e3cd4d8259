"""The port's copies of the brute-force oracle (``core/oracle.py``) and the
binary-join and leapfrog baselines (``core/baselines.py``) against the
reference's, on ``tests/test_core_property.py``'s instances (chains,
stars, self-joins, triangles, 4-cycles, a bowtie and 3-attribute
hyperedges over domains of 1-5 values).

The same tables go through both packages' encoders; the oracle's rows,
its sorted matrix and grouped RLE, and each baseline's flat result (as a
multiset), row count and peak intermediate size are held equal, and the
port's GraphicalJoin on the CPU gives the oracle's sorted rows.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings

from repro.core import baselines as ref_baselines
from repro.core import oracle as ref_oracle
from repro.relational.encoding import encode_query as ref_encode_query

from repro_torch.core import baselines, oracle
from repro_torch.core.api import GraphicalJoin
from repro_torch.interop import catalog_from_arrays
from repro_torch.relational.encoding import encode_query
from repro_torch.relational.query import JoinQuery

from test_core_property import COMMON, _mk_query, join_instances
import torch_threads  # noqa: F401

pytestmark = pytest.mark.slow


def encoded_twins(inst):
    """(the reference's EncodedQuery, the port's, the port's catalog and
    query) over the same tables."""
    cat, query = inst
    tables, _ = _mk_query(query.name)
    pcat = catalog_from_arrays({n: dict(t.columns)
                                for n, t in cat.tables.items()})
    pquery = JoinQuery.of(query.name, [(t, vm) for t, vm, _ in tables])
    return (ref_encode_query(cat, query), encode_query(pcat, pquery), pcat,
            pquery)


def rows_of(cols, order):
    if not len(cols[order[0]]):
        return np.zeros((0, len(order)), np.int64)
    return oracle.sort_rows(cols, order)


@settings(max_examples=60, **COMMON)
@given(join_instances())
def test_oracle_matches_reference(inst):
    ref_enc, enc, pcat, pquery = encoded_twins(inst)
    want = ref_oracle.oracle_join(ref_enc)
    got = oracle.oracle_join(enc)
    order = list(enc.query.variables)
    assert list(got) == list(want) == order
    for v in order:
        np.testing.assert_array_equal(got[v], want[v])
    mat = rows_of(got, order)
    np.testing.assert_array_equal(mat, rows_of(want, order))
    groups = [1] * len(order)
    for (gv, gf), (wv, wf) in zip(oracle.grouped_rle(mat, groups),
                                  ref_oracle.grouped_rle(mat, groups)):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)
    # the port's GraphicalJoin on the CPU against its own oracle
    gj = GraphicalJoin(pcat, pquery, device="cpu")
    gfjs = gj.run()
    res = gj.desummarize(gfjs, decode=False)
    cols = gfjs.column_order
    assert gfjs.join_size == len(mat)
    np.testing.assert_array_equal(
        rows_of(res, cols) if gfjs.join_size else
        np.zeros((0, len(cols)), np.int64), rows_of(got, cols))


@settings(max_examples=60, **COMMON)
@given(join_instances())
def test_baselines_match_reference(inst):
    ref_enc, enc, _, _ = encoded_twins(inst)
    order = list(enc.query.variables)
    for name in ("leapfrog_join", "binary_join_plan"):
        want = getattr(ref_baselines, name)(ref_enc)
        got = getattr(baselines, name)(enc)
        assert got.rows == want.rows
        assert got.peak_intermediate == want.peak_intermediate
        assert set(got.columns) == set(want.columns)
        if got.rows:
            np.testing.assert_array_equal(
                oracle.sort_rows(got.columns, order),
                oracle.sort_rows(want.columns, order))
