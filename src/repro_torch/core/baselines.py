"""Competitor join algorithms, for the paper's experimental comparison.

* :func:`binary_join_plan` — a left-deep binary-join plan over sorted-merge
  products, materializing every intermediate result.  This is the execution
  model of PostgreSQL/MonetDB in the paper's tables; it pays the full UIR
  cost, which the benchmarks surface as ``peak_intermediate`` rows.
* :func:`leapfrog_join` — a generic worst-case-optimal join over the *data*
  (the execution model of Umbra's WOJA): breadth-first variable-at-a-time
  binding over distinct keys with semijoin filtering, then one multiplicity
  expansion to the flat result.  Avoids UIR but still materializes the full
  redundant join result (the cost GJ's summary avoids).

Both operate on the same encoded inputs as GJ so comparisons isolate the
algorithm, not parsing or storage engines (DESIGN.md §8).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.potentials import INT, Factor
from repro_torch.core.potential_join import multiway_product
from repro_torch.core.gfjs import _expand
from repro_torch.relational.encoding import EncodedQuery


@dataclass
class JoinRunResult:
    columns: Dict[str, np.ndarray]      # flat join result (encoded codes)
    rows: int
    peak_intermediate: int              # max intermediate rows materialized
    seconds: float


def _row_factor(cols: Dict[str, np.ndarray], sizes: Dict[str, int]) -> Factor:
    names = tuple(cols.keys())
    keys = np.stack([np.asarray(cols[v], dtype=INT) for v in names], axis=1)
    n = keys.shape[0]
    return Factor(names, keys, np.ones(n, INT), np.ones(n, INT),
                  tuple(int(sizes[v]) for v in names))


def binary_join_plan(
    enc: EncodedQuery, order: Optional[Sequence[int]] = None
) -> JoinRunResult:
    """Left-deep binary plan; ``order`` permutes the table sequence."""
    t0 = time.perf_counter()
    sizes = enc.domain_sizes()
    tables = [_row_factor(c, sizes) for c in enc.encoded_tables]
    if order is not None:
        tables = [tables[i] for i in order]
    acc = tables[0]
    peak = acc.num_entries
    rest = tables[1:]
    while rest:
        nxt = next((f for f in rest if set(f.vars) & set(acc.vars)), rest[0])
        rest.remove(nxt)
        acc = acc.multiply(nxt)
        peak = max(peak, acc.num_entries)
    out_vars = enc.query.output_variables
    acc = acc.project(tuple(out_vars))
    cols = {v: acc.col(v).copy() for v in out_vars}
    return JoinRunResult(cols, acc.num_entries, peak, time.perf_counter() - t0)


def leapfrog_join(
    enc: EncodedQuery, var_order: Optional[Sequence[str]] = None
) -> JoinRunResult:
    """Generic WCOJ over data: distinct-key frontier + final expansion.

    The frontier over bound variables is AGM-bounded per prefix (no UIR);
    multiplicities are applied once at the end, costing exactly |Q|.
    """
    t0 = time.perf_counter()
    sizes = enc.domain_sizes()
    # grouped potentials (the 'tries'): unique keys + multiplicities
    pots = [Factor.from_columns(c, sizes) for c in enc.encoded_tables]
    order = list(var_order) if var_order else list(enc.query.variables)
    joint = multiway_product(pots, var_order=order)
    peak = joint.num_entries
    # expand multiplicities to the flat result
    mult = joint.bucket * joint.fac
    src, _ = _expand(mult)
    out_vars = enc.query.output_variables
    proj = joint.project(tuple(out_vars))
    cols = {v: proj.keys[src, i].copy() for i, v in enumerate(proj.vars)}
    rows = int(mult.sum())
    return JoinRunResult(cols, rows, peak, time.perf_counter() - t0)


def store_result_csv(columns: Dict[str, np.ndarray], domains, path: str) -> int:
    """Write a flat join result as CSV (what the competitors store on disk)."""
    import os
    names = list(columns.keys())
    cols = [domains[v].decode(columns[v]) if domains else columns[v] for v in names]
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        n = len(cols[0]) if cols else 0
        CHUNK = 1 << 16
        for lo in range(0, n, CHUNK):
            hi = min(lo + CHUNK, n)
            block = np.stack([np.asarray(c[lo:hi]).astype(str) for c in cols], axis=1)
            f.write("\n".join(",".join(r) for r in block) + "\n")
    return os.path.getsize(path)


def store_result_binary(columns: Dict[str, np.ndarray], path: str) -> int:
    """Columnar binary storage of a flat result (MonetDB-style), compressed.

    Frames are self-describing: each column is one length-prefixed compressed
    block so the loader needs no external schema (see benchmarks/tables.py).
    """
    import os
    import struct

    from repro_torch.core.storage import compress_bytes
    with open(path, "wb") as f:
        for v, c in columns.items():
            codec, comp = compress_bytes(np.ascontiguousarray(c).tobytes())
            f.write(struct.pack("<4sQ", codec.encode().ljust(4), len(comp)))
            f.write(comp)
    return os.path.getsize(path)
