"""TPC-H's customer, orders and lineitem keys, populated by the rules of
the TPC-H specification (v3, Clause 4.2.3) at scale factor ``sf``.

- ``customer``: ``c_custkey`` 1..150,000·SF, ``c_nationkey`` uniform over
  the 25 nations.
- ``orders``: 1,500,000·SF orders with sparse keys (the first 8 of every
  32), ``o_custkey`` uniform over the customers whose key is not a
  multiple of 3 (a third of the customers place no order).
- ``lineitem``: 1 to 7 lines per order, uniform, ``l_partkey`` uniform
  over 1..200,000·SF.

Only the columns the benchmark's queries read are made.  The draws come
from ``data_seed``, so every run seed joins the same population and does
the same work: the run seed permutes the customer keys within each class
of key mod 3 (so the rule above holds) and the order, part and nation
keys.  Each table's rows are in its key's order, as ``dbgen`` writes them
(lineitem by ``l_orderkey``).
"""

from __future__ import annotations

import numpy as np

from gjbench.data import Data


def population(sizes: dict, data_seed: int):
    sf = sizes["scale_factor"]
    n_cust = int(sizes["customer_per_sf"] * sf)
    n_ord = int(sizes["orders_per_sf"] * sf)
    n_part = int(sizes["part_per_sf"] * sf)
    lo, hi = sizes["lineitems_per_order"]
    rng = np.random.default_rng(data_seed)
    custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    nationkey = rng.integers(0, sizes["nations"], n_cust, dtype=np.int64)
    i = np.arange(n_ord, dtype=np.int64)
    orderkey = (i // 8) * 32 + (i % 8) + 1
    ordering = custkey[custkey % 3 != 0]
    o_custkey = ordering[rng.integers(0, len(ordering), n_ord)]
    lines = rng.integers(lo, hi + 1, n_ord)
    l_orderkey = np.repeat(orderkey, lines)
    l_partkey = rng.integers(1, n_part + 1, len(l_orderkey), dtype=np.int64)
    return {
        "customer": {"c_custkey": custkey, "c_nationkey": nationkey},
        "orders": {"o_orderkey": orderkey, "o_custkey": o_custkey},
        "lineitem": {"l_orderkey": l_orderkey, "l_partkey": l_partkey},
    }, n_part, sizes["nations"]


def _permutation(rng, keys: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """A table, indexed by key, that maps ``keys`` onto themselves within
    each class."""
    out = np.zeros(int(keys.max()) + 1, dtype=np.int64)
    for c in np.unique(classes):
        at = keys[classes == c]
        out[at] = at[rng.permutation(len(at))]
    return out


def generate(sizes: dict, data_seed: int, seed: int) -> Data:
    base, n_part, n_nat = population(sizes, data_seed)
    rng = np.random.default_rng(seed)
    cust = base["customer"]["c_custkey"]
    order = base["orders"]["o_orderkey"]
    maps = {"c": _permutation(rng, cust, cust % 3 == 0),
            "o": _permutation(rng, order, np.zeros(len(order))),
            "p": _permutation(rng, np.arange(1, n_part + 1),
                              np.zeros(n_part)),
            "n": _permutation(rng, np.arange(n_nat), np.zeros(n_nat))}
    which = {"c_custkey": "c", "o_custkey": "c", "o_orderkey": "o",
             "l_orderkey": "o", "l_partkey": "p", "c_nationkey": "n"}
    key = {"customer": "c_custkey", "orders": "o_orderkey",
           "lineitem": "l_orderkey"}
    tables = {}
    for t, cols in base.items():
        cols = {c: maps[which[c]][v] for c, v in cols.items()}
        rows = np.argsort(cols[key[t]], kind="stable")
        tables[t] = {c: v[rows] for c, v in cols.items()}
    return Data(tables)
