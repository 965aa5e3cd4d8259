"""Carry state across from the reference package as numpy arrays and dicts.

The port shares no class with ``repro``: these builders take the plain
arrays a reference catalog or GFJS holds and make the port's own objects,
so the same data can go through both packages.

    cat = catalog_from_arrays({t.name: dict(t.columns)
                               for t in ref_catalog.tables.values()})
    gfjs = gfjs_from_arrays([(lvl.vars, lvl.key_cols, lvl.freq)
                             for lvl in ref_gfjs.levels],
                            ref_gfjs.column_order, ref_gfjs.join_size,
                            {v: d.values for v, d in ref_gfjs.domains.items()})
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.gfjs import GFJS, LevelSummary
from repro_torch.core.potentials import INT
from repro_torch.relational.encoding import Domain
from repro_torch.relational.table import Catalog, Table


def catalog_from_arrays(
        tables: Mapping[str, Mapping[str, np.ndarray]]) -> Catalog:
    """``{table: {column: values}}`` -> the port's :class:`Catalog`."""
    return Catalog.of(*(Table(name, dict(cols))
                        for name, cols in tables.items()))


def gfjs_from_arrays(
        levels: Sequence[Tuple[Sequence[str], Mapping[str, np.ndarray],
                               np.ndarray]],
        column_order: Sequence[str], join_size: int,
        domain_values: Mapping[str, np.ndarray]) -> GFJS:
    """Per-level ``(vars, {var: codes per run}, freq)`` -> the port's GFJS.

    ``domain_values`` holds each variable's sorted unique raw values (the
    dictionary its codes index).
    """
    out = []
    for vars_, key_cols, freq in levels:
        vars_ = tuple(vars_)
        freq = np.asarray(freq, dtype=INT)
        cols = {v: np.asarray(key_cols[v], dtype=INT) for v in vars_}
        if any(len(c) != len(freq) for c in cols.values()):
            raise ValueError(f"level {vars_}: code columns and freq differ "
                             "in length")
        out.append(LevelSummary(vars_, cols, freq))
    sizes = {int(lvl.freq.sum()) for lvl in out}
    if sizes - {int(join_size)}:
        raise ValueError(f"level frequencies sum to {sorted(sizes)}, "
                         f"not join_size {join_size}")
    domains: Dict[str, Domain] = {v: Domain(v, np.asarray(vals))
                                  for v, vals in domain_values.items()}
    return GFJS(out, list(column_order), int(join_size), domains)
