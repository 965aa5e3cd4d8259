"""Join-query descriptions.

A :class:`JoinQuery` is an n-way natural equi-join over *variables*.  Each
participating table maps some of its columns onto query variables via
``var_map`` (column name -> variable name); two occurrences of the same
variable join.  Renaming through ``var_map`` supports self-joins (e.g. the
paper's lastFM_A1 joins ``user_artists`` twice under different variables)
and cyclic queries (triangles).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class QueryTable:
    """One occurrence of a base table inside a join query."""

    table: str                       # base-table name in the catalog
    var_map: Tuple[Tuple[str, str], ...]  # (column, variable) pairs

    @staticmethod
    def of(table: str, var_map: Dict[str, str]) -> "QueryTable":
        return QueryTable(table, tuple(sorted(var_map.items())))

    @property
    def variables(self) -> Tuple[str, ...]:
        return tuple(v for _, v in self.var_map)

    @property
    def columns(self) -> Tuple[str, ...]:
        return tuple(c for c, _ in self.var_map)


@dataclass(frozen=True)
class JoinQuery:
    """An n-way equi-join: SELECT <output> FROM tables NATURAL-JOIN on vars."""

    name: str
    tables: Tuple[QueryTable, ...]
    output: Optional[Tuple[str, ...]] = None  # None => all variables

    @staticmethod
    def of(
        name: str,
        tables: Sequence[Tuple[str, Dict[str, str]]],
        output: Optional[Sequence[str]] = None,
    ) -> "JoinQuery":
        qts = tuple(QueryTable.of(t, vm) for t, vm in tables)
        return JoinQuery(name, qts, tuple(output) if output is not None else None)

    # -- structural helpers ----------------------------------------------
    @property
    def variables(self) -> List[str]:
        seen: List[str] = []
        for qt in self.tables:
            for v in qt.variables:
                if v not in seen:
                    seen.append(v)
        return seen

    @property
    def output_variables(self) -> List[str]:
        if self.output is None:
            return self.variables
        return list(self.output)

    def hyperedges(self) -> List[FrozenSet[str]]:
        """One hyperedge (clique) per table occurrence."""
        return [frozenset(qt.variables) for qt in self.tables]

    def join_variables(self) -> Set[str]:
        """Variables appearing in >= 2 table occurrences."""
        count: Dict[str, int] = {}
        for qt in self.tables:
            for v in set(qt.variables):
                count[v] = count.get(v, 0) + 1
        return {v for v, c in count.items() if c >= 2}

    def canonical_labels(self) -> Dict[str, str]:
        """Variable -> alias-insensitive canonical label.

        Output variables keep their literal names: they surface as GFJS /
        frame column names, so two queries that differ in *output* naming
        are not interchangeable.  Projected-out variables never appear in
        any result (psis are built only for output variables), so their
        names are pure syntax — they are relabeled by structure: a
        Weisfeiler-Lehman-style color over (contributing (table, column)
        pairs, co-occurrence neighborhoods).  Two internal variables that
        still share a color after refinement fall back to their literal
        names — a conservative choice that loses cross-alias sharing but
        can never conflate genuinely different roles (e.g. the two sides
        of a symmetric self-join).
        """
        variables = self.variables
        out_set = set(self.output) if self.output is not None else None
        if out_set is None:
            return {v: v for v in variables}
        internal = [v for v in variables if v not in out_set]
        if not internal:
            return {v: v for v in variables}

        def _h(obj) -> str:
            return hashlib.sha256(
                json.dumps(obj, separators=(",", ":")).encode()).hexdigest()[:16]

        color: Dict[str, str] = {}
        for v in variables:
            contrib = sorted(
                [qt.table, c]
                for qt in self.tables for c, u in qt.var_map if u == v)
            seed = ["out", v] if v in out_set else ["int"]
            color[v] = _h([seed, contrib])
        # refine over occurrence co-membership until internal colors are as
        # distinct as they will get (bounded by the number of internal vars)
        for _ in range(len(internal)):
            neigh: Dict[str, List] = {v: [] for v in variables}
            for qt in self.tables:
                occ = sorted([c, color[u]] for c, u in qt.var_map)
                for c, u in qt.var_map:
                    neigh[u].append([qt.table, c, occ])
            new = {v: _h([color[v], sorted(neigh[v])]) for v in variables}
            if len(set(new[v] for v in internal)) \
                    == len(set(color[v] for v in internal)):
                color = new
                break
            color = new
        counts: Dict[str, int] = {}
        for v in internal:
            counts[color[v]] = counts.get(color[v], 0) + 1
        labels = {v: v for v in variables}
        for v in internal:
            if counts[color[v]] == 1:
                labels[v] = "~" + color[v]
        return labels

    def fingerprint(self, plan=None, *, literal: bool = False) -> str:
        """Canonical content hash of the join shape (cache key half).

        Two queries that join the same table occurrences on the same
        variables with the same projection hash identically, regardless of
        the order tables were listed in, the query's display ``name``, or
        the insertion order inside each ``var_map``.  An explicit projection
        equal to all variables canonicalizes to the implicit one, and
        projected-out variables are relabeled through
        :meth:`canonical_labels`, so syntactically permuted or
        alias-renamed but semantically identical queries share whole-query
        cache keys.  ``literal=True`` skips the relabeling — for keys that
        index artifacts carrying literal variable names (e.g. the
        `JoinService` plan cache, whose plans embed the query's own
        elimination-order names and must not be served to a renamed twin).

        ``plan`` (a ``repro.plan.ir.PhysicalPlan``, or anything with a
        ``signature()`` method) folds the chosen physical plan into the
        hash: the GFJS depends on the elimination order, so summaries built
        under different plans must never share a cache entry.  ``None``
        keeps the plan-agnostic hash (pre-planner compatibility).
        """
        labels = {v: v for v in self.variables} if literal \
            else self.canonical_labels()
        occurrences = sorted(
            (qt.table, tuple(sorted((c, labels[u]) for c, u in qt.var_map)))
            for qt in self.tables)
        output = self.output
        if output is not None and sorted(output) == sorted(self.variables):
            output = None
        canon = {
            "tables": [[t, list(map(list, vm))] for t, vm in occurrences],
            "output": sorted(output) if output is not None else None,
        }
        if plan is not None:
            if any(labels[v] != v for v in labels):
                try:
                    canon["plan"] = plan.signature(labels=labels)
                except TypeError:   # duck-typed plan without label support
                    canon["plan"] = plan.signature()
            else:
                canon["plan"] = plan.signature()
        return hashlib.sha256(
            json.dumps(canon, separators=(",", ":")).encode()).hexdigest()

    def is_cyclic(self) -> bool:
        """True iff the query hypergraph is cyclic (GYO reduction fails).

        GYO: repeatedly remove 'ear' hyperedges (edges whose variables are
        all private or contained in another edge).  Acyclic iff reduction
        empties the edge set.
        """
        edges = [set(e) for e in self.hyperedges()]
        changed = True
        while changed and len(edges) > 1:
            changed = False
            for i, e in enumerate(edges):
                others: Set[str] = set()
                for j, o in enumerate(edges):
                    if j != i:
                        others |= o
                shared = e & others
                # e is an ear if its shared part is contained in one other edge
                for j, o in enumerate(edges):
                    if j != i and shared <= o:
                        edges.pop(i)
                        changed = True
                        break
                if changed:
                    break
        return len(edges) > 1
