"""Answers of an acyclic join of binary relations, worked out from the tables.

A query is a list of ``[table, {column: variable}]`` with two columns each,
whose relations form a tree over the variables (every query of the
benchmark is a chain).  Its result is the multiset of assignments that
agree with one row of every relation, each counted by the product of the
rows' multiplicities.

:func:`propagate` runs sum-product over that tree: ``weights`` give each
variable a value per domain entry, and the root's belief is, for each of
its values, the sum over result rows with that value of the product of
their weights.  With unit weights it is GROUP BY root COUNT(*), and its sum
is |Q|.  Three rings: exact ``int64`` counts (sums taken in float64, exact
below 2^53), counts accumulated in ``float32`` (the control), and sums
modulo the prime ``P`` (the fingerprint of :mod:`gjbench.reference.rows`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

P = (1 << 31) - 1          # a Mersenne prime: products of two residues fit int64

Query = Sequence[Tuple[str, Dict[str, str]]]


@dataclass
class Edge:
    a: str                 # variable of the first column
    b: str                 # variable of the second column
    xa: np.ndarray         # local ids (into the domain of a), int64
    xb: np.ndarray


@dataclass
class Tree:
    domains: Dict[str, np.ndarray]     # variable -> sorted unique raw values
    edges: List[Edge]

    def neighbours(self, var: str) -> List[Tuple[int, str]]:
        out = []
        for i, e in enumerate(self.edges):
            if e.a == var:
                out.append((i, e.b))
            elif e.b == var:
                out.append((i, e.a))
        return out


def build(query: Query, tables: Dict[str, Dict[str, np.ndarray]]) -> Tree:
    """Domains (the union of a variable's columns) and the encoded edges."""
    cols: Dict[str, List[np.ndarray]] = {}
    pairs = []
    for table, binding in query:
        if len(binding) != 2:
            raise ValueError(f"{table}: the reference joins binary relations")
        (ca, va), (cb, vb) = binding.items()
        t = tables[table]
        cols.setdefault(va, []).append(t[ca])
        cols.setdefault(vb, []).append(t[cb])
        pairs.append((va, vb, t[ca], t[cb]))
    domains = {v: np.unique(np.concatenate(c)) for v, c in cols.items()}
    edges = [Edge(va, vb, np.searchsorted(domains[va], a),
                  np.searchsorted(domains[vb], b))
             for va, vb, a, b in pairs]
    if len(edges) != len(domains) - 1:
        raise ValueError("the reference joins trees of relations only")
    return Tree(domains, edges)


def _segsum(idx: np.ndarray, vals: np.ndarray, n: int, ring: str
            ) -> np.ndarray:
    if ring == "f32":
        out = np.zeros(n, np.float32)
        np.add.at(out, idx, vals.astype(np.float32))
        return out
    if ring == "mod":
        # exact: 16-bit halves keep every float64 partial sum below 2^53
        lo = np.bincount(idx, vals & 0xFFFF, minlength=n)
        hi = np.bincount(idx, vals >> 16, minlength=n)
        return ((hi.astype(np.int64) % P) * 65536 + lo.astype(np.int64)) % P
    return np.rint(np.bincount(idx, vals.astype(np.float64),
                               minlength=n)).astype(np.int64)


def _mul(x: np.ndarray, y: np.ndarray, ring: str) -> np.ndarray:
    if ring == "mod":
        return (x * y) % P
    return x * y


def propagate(tree: Tree, root: str,
              weights: Optional[Dict[str, np.ndarray]] = None,
              ring: str = "count") -> np.ndarray:
    """The root's belief over its domain (see the module's docstring)."""
    dt = np.float32 if ring == "f32" else np.int64

    def unit(v):
        w = (weights or {}).get(v)
        n = len(tree.domains[v])
        return np.ones(n, dt) if w is None else np.asarray(w).astype(dt)

    def belief(var: str, via: Optional[int]) -> np.ndarray:
        b = unit(var)
        for i, other in tree.neighbours(var):
            if i == via:
                continue
            e = tree.edges[i]
            src, dst = (e.xb, e.xa) if e.a == var else (e.xa, e.xb)
            m = belief(other, i)[src]
            b = _mul(b, _segsum(dst, m, len(b), ring), ring)
        return b

    return belief(root, None)


def count(tree: Tree, ring: str = "count") -> int:
    """|Q|."""
    root = tree.edges[0].a
    return int(propagate(tree, root, None, ring).sum())


def group_count(tree: Tree, var: str, ring: str = "count"
                ) -> Dict[str, np.ndarray]:
    """GROUP BY ``var`` COUNT(*): groups with a nonzero count, by value."""
    b = propagate(tree, var, None, ring)
    counts = np.rint(b).astype(np.int64) if ring == "f32" else b
    live = counts != 0
    return {var: tree.domains[var][live], "count": counts[live]}
