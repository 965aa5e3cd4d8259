"""Brute-force reference join — the ground truth for every GJ test.

Materializes the full n-way join by left-deep pairwise sorted-merge products
over *row-level* factors (one entry per tuple, multiplicity 1), so the output
is the exact join multiset.  Only safe for test-sized inputs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.potentials import INT, Factor
from repro_torch.relational.encoding import EncodedQuery


def _row_factor(cols: Dict[str, np.ndarray], sizes: Dict[str, int]) -> Factor:
    names = tuple(cols.keys())
    keys = np.stack([np.asarray(cols[v], dtype=INT) for v in names], axis=1)
    n = keys.shape[0]
    return Factor(names, keys, np.ones(n, INT), np.ones(n, INT),
                  tuple(int(sizes[v]) for v in names))


def oracle_join(enc: EncodedQuery) -> Dict[str, np.ndarray]:
    """Full join result (encoded codes), all query variables, unsorted."""
    sizes = enc.domain_sizes()
    fs = [_row_factor(c, sizes) for c in enc.encoded_tables]
    # join connected-first to avoid Cartesian products
    acc = fs[0]
    rest = fs[1:]
    while rest:
        nxt = next((f for f in rest if set(f.vars) & set(acc.vars)), rest[0])
        rest.remove(nxt)
        acc = acc.multiply(nxt)
    out_vars = enc.query.variables
    acc = acc.project(tuple(out_vars))
    return {v: acc.col(v).copy() for v in out_vars}


def sort_rows(cols: Dict[str, np.ndarray], order: Sequence[str]) -> np.ndarray:
    """Row matrix [n, k] sorted lexicographically by ``order``."""
    mat = np.stack([np.asarray(cols[v], dtype=INT) for v in order], axis=1)
    idx = np.lexsort(mat.T[::-1])
    return mat[idx]


def grouped_rle(
    sorted_mat: np.ndarray, groups: Sequence[int]
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-level grouped RLE of a sorted row matrix (Definition 1).

    ``groups`` gives how many columns each GFJS level spans (1 for ordinary
    levels; >1 for joint Cartesian levels).  A level's runs break whenever
    the *prefix through that level* changes — the 'Grouped' in GFJS.
    Returns [(values [runs, group_width], freqs)] per level.
    """
    n, k = sorted_mat.shape
    assert sum(groups) == k
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    if n == 0:
        return [(np.zeros((0, g), INT), np.zeros(0, INT)) for g in groups]
    change = np.zeros(n, dtype=bool)
    change[0] = True
    col = 0
    for g in groups:
        for i in range(col, col + g):
            change[1:] |= sorted_mat[1:, i] != sorted_mat[:-1, i]
        starts = np.flatnonzero(change)
        freqs = np.diff(np.append(starts, n)).astype(INT)
        out.append((sorted_mat[starts][:, col:col + g].copy(), freqs))
        col += g
    return out
