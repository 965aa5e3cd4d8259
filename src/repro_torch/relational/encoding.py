"""Dictionary encoding of attribute domains.

Every query variable gets a :class:`Domain`: the sorted union of the raw
values that variable takes across all of its table occurrences.  Encoding a
column maps raw values to dense int codes (positions in the sorted unique
array).  Because codes are assigned in sorted raw order, *sorting by code ==
sorting by raw value*, which is what makes the GFJS produced downstream equal
to the RLE of the value-sorted join result.

This is the "strings are parsed once at ingest" hardware adaptation recorded
in DESIGN.md §6: TPUs operate on the dense code arrays, raw values are only
touched at the ingest/export boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.relational.query import JoinQuery
from repro_torch.relational.table import Catalog


@dataclass
class Domain:
    """Sorted unique raw values of one query variable."""

    variable: str
    values: np.ndarray  # sorted unique raw values

    @property
    def size(self) -> int:
        return len(self.values)

    def encode(self, raw: np.ndarray) -> np.ndarray:
        """Raw values -> int32 codes; -1 for values outside the domain."""
        pos = np.searchsorted(self.values, raw)
        pos = np.clip(pos, 0, max(self.size - 1, 0))
        ok = self.size > 0
        match = (self.values[pos] == raw) if ok else np.zeros(len(raw), bool)
        codes = np.where(match, pos, -1).astype(np.int64)
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.values[np.asarray(codes, dtype=np.int64)]


@dataclass
class EncodedQuery:
    """A join query with all touched columns dictionary-encoded."""

    query: JoinQuery
    domains: Dict[str, Domain]
    # per query-table-occurrence: variable -> encoded int64 code column
    encoded_tables: List[Dict[str, np.ndarray]]

    def domain_sizes(self) -> Dict[str, int]:
        return {v: d.size for v, d in self.domains.items()}


def encode_query(catalog: Catalog, query: JoinQuery) -> EncodedQuery:
    """Build per-variable domains (union across occurrences) and encode.

    One pass to collect uniques, one pass to encode: O(N log N) per column
    from the sorts, performed once per (table, query-shape) — the paper's
    'potentials may have been calculated for previous queries' amortization
    point applies here too.

    Each occurrence's Table object is snapshotted once up front: tables are
    immutable, so both passes see one consistent version even if the
    catalog entry is concurrently replaced by an append.
    """
    tables = [catalog[qt.table] for qt in query.tables]

    raw_cols: Dict[str, List[np.ndarray]] = {}
    for qt, tab in zip(query.tables, tables):
        for col, var in qt.var_map:
            raw_cols.setdefault(var, []).append(tab[col])

    domains: Dict[str, Domain] = {}
    for var, cols in raw_cols.items():
        kinds = {c.dtype.kind for c in cols}
        if len(kinds) > 1:
            raise TypeError(f"variable {var!r} joins columns of mixed kinds {kinds}")
        uniq = np.unique(np.concatenate([np.unique(c) for c in cols]))
        domains[var] = Domain(var, uniq)

    encoded_tables: List[Dict[str, np.ndarray]] = []
    for qt, tab in zip(query.tables, tables):
        enc: Dict[str, np.ndarray] = {}
        for col, var in qt.var_map:
            enc[var] = domains[var].encode(tab[col])
        encoded_tables.append(enc)

    return EncodedQuery(query, domains, encoded_tables)
