"""Qualitative PGM structure for a join query.

Implements the paper's Section 2.2/3.2 machinery: the query MRF (one node per
variable, one clique per table occurrence), min-fill triangulation producing
an elimination order + maxcliques, and the junction tree via maximal
spanning tree over separator sizes, with a Running-Intersection-Property
verifier used by the test suite.

Early projection (paper §3.7): non-output variables are placed *first* in
the elimination order (the paper's O' before O); the elimination driver
skips emitting conditional factors for them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.relational.query import JoinQuery


@dataclass
class QueryGraph:
    """Primal (moralized) graph of the query MRF."""

    variables: List[str]
    adjacency: Dict[str, Set[str]]
    hyperedges: List[FrozenSet[str]]   # one clique per query table

    @staticmethod
    def from_query(query: JoinQuery) -> "QueryGraph":
        variables = query.variables
        adj: Dict[str, Set[str]] = {v: set() for v in variables}
        edges = query.hyperedges()
        for e in edges:
            vs = sorted(e)
            for i, u in enumerate(vs):
                for w in vs[i + 1:]:
                    adj[u].add(w)
                    adj[w].add(u)
        return QueryGraph(variables, adj, edges)

    def is_connected(self) -> bool:
        if not self.variables:
            return True
        seen = {self.variables[0]}
        stack = [self.variables[0]]
        while stack:
            u = stack.pop()
            for w in self.adjacency[u]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == len(self.variables)


@dataclass
class Triangulation:
    """Output of min-fill: order, fill-in edges, maxcliques, parents."""

    order: List[str]                       # elimination order
    fill_edges: List[Tuple[str, str]]
    cliques: List[FrozenSet[str]]          # elimination cliques ({v} ∪ nbrs(v))
    maxcliques: List[FrozenSet[str]]
    parents: Dict[str, Tuple[str, ...]]    # v -> separator (nbrs at elim time)


def min_fill_order(
    graph: QueryGraph,
    *,
    first: Optional[Sequence[str]] = None,
    forced_order: Optional[Sequence[str]] = None,
) -> Triangulation:
    """Min-fill heuristic (paper §2.2.1).

    ``first``: variables that must be eliminated before all others (early
    projection's O'); within each group ties break by fill count then name.
    ``forced_order``: full user-specified order (overrides the heuristic).
    """
    adj = {v: set(ns) for v, ns in graph.adjacency.items()}
    remaining = set(graph.variables)
    first_set = set(first or ())

    order: List[str] = []
    fill_edges: List[Tuple[str, str]] = []
    cliques: List[FrozenSet[str]] = []
    parents: Dict[str, Tuple[str, ...]] = {}

    def fill_count(v: str) -> int:
        ns = list(adj[v])
        cnt = 0
        for i, a in enumerate(ns):
            for b in ns[i + 1:]:
                if b not in adj[a]:
                    cnt += 1
        return cnt

    forced = list(forced_order) if forced_order is not None else None
    step = 0
    while remaining:
        if forced is not None:
            v = forced[step]
            step += 1
        else:
            pool = remaining & first_set if remaining & first_set else remaining
            v = min(pool, key=lambda u: (fill_count(u), u))
        remaining.discard(v)

        nbrs = sorted(adj[v] & remaining)
        parents[v] = tuple(nbrs)
        cliques.append(frozenset([v, *nbrs]))
        # connect the neighbours (fill-in edges)
        for i, a in enumerate(nbrs):
            for b in nbrs[i + 1:]:
                if b not in adj[a]:
                    adj[a].add(b)
                    adj[b].add(a)
                    fill_edges.append((a, b))
        for a in nbrs:
            adj[a].discard(v)
        order.append(v)

    # maxcliques = elimination cliques not contained in a later clique
    maxcliques: List[FrozenSet[str]] = []
    for i, c in enumerate(cliques):
        if not any(c < cliques[j] for j in range(len(cliques)) if j != i) and \
           not any(c == m for m in maxcliques):
            maxcliques.append(c)
    return Triangulation(order, fill_edges, cliques, maxcliques, parents)


def structurally_acyclic(graph: QueryGraph) -> bool:
    """True iff the query hypergraph is alpha-acyclic.

    Beeri et al.: a hypergraph is alpha-acyclic iff its primal graph is
    chordal AND conformal (every maximal clique of the primal graph is
    contained in some hyperedge).  Chordality falls out of an
    unconstrained min-fill sweep — on a chordal graph a simplicial
    (zero-fill) vertex always exists and eliminating it preserves
    chordality, so the heuristic adds no fill edges exactly when the graph
    is chordal; the sweep's maxcliques are then the maximal cliques the
    conformality check needs.

    The planner uses this as the hybrid gate: acyclic queries never get
    bag steps, so their plan signatures (and cache keys) are unchanged.
    """
    tri = min_fill_order(graph)
    if tri.fill_edges:
        return False
    return all(any(c <= e for e in graph.hyperedges) for c in tri.maxcliques)


def decompose_bags(
    graph: QueryGraph, order: Sequence[str]
) -> Tuple[List[Tuple[Tuple[str, ...], Tuple[int, ...]]], Triangulation]:
    """Cover the table occurrences with cliques of ``order``'s triangulation.

    Returns ``(bags, tri)`` where each bag is ``(scope, occurrences)``:
    ``occurrences`` indexes ``graph.hyperedges`` (== the query's table
    occurrences in encoding order) and ``scope`` is the union of their
    variables, listed in elimination order (the global attribute order a
    WCOJ bag step binds in).  Only bags joining >= 2 occurrences are
    returned; singleton occurrences stay ordinary per-table factors.

    Every hyperedge is a clique of the primal graph, hence of the
    triangulated graph, hence contained in one of its maximal cliques —
    so assignment never fails.  Each occurrence goes to the containing
    maxclique that contains the most hyperedges overall (co-location:
    the whole cyclic core lands in one bag when a clique covers it),
    ties broken toward smaller cliques then discovery order, so the
    decomposition is deterministic given the order.

    Keeping every bag inside a clique of the *chosen order's*
    triangulation is what makes hybrid execution bit-identical to the
    monolithic build: elimination over bag potentials then meets exactly
    the same separators (parents) at every step as elimination over the
    raw table factors (see DESIGN.md §19 for the induction).
    """
    tri = min_fill_order(graph, forced_order=order)
    contains = [[i for i, e in enumerate(graph.hyperedges) if e <= c]
                for c in tri.maxcliques]
    assignment: Dict[int, int] = {}
    for i, e in enumerate(graph.hyperedges):
        cands = [j for j, c in enumerate(tri.maxcliques) if e <= c]
        if not cands:  # pragma: no cover - chordal-cover invariant
            continue
        assignment[i] = max(
            cands, key=lambda j: (len(contains[j]), -len(tri.maxcliques[j]), -j))
    grouped: Dict[int, List[int]] = {}
    for i in sorted(assignment):
        grouped.setdefault(assignment[i], []).append(i)
    bags: List[Tuple[Tuple[str, ...], Tuple[int, ...]]] = []
    for j in sorted(grouped):
        occs = grouped[j]
        if len(occs) < 2:
            continue
        scope_set: Set[str] = set()
        for i in occs:
            scope_set |= graph.hyperedges[i]
        scope = tuple(v for v in order if v in scope_set)
        bags.append((scope, tuple(occs)))
    return bags, tri


@dataclass
class JunctionTree:
    """Tree of maxcliques with separators (paper §2.2.1)."""

    cliques: List[FrozenSet[str]]
    edges: List[Tuple[int, int, FrozenSet[str]]]  # (i, j, separator)

    def neighbors(self, i: int) -> List[Tuple[int, FrozenSet[str]]]:
        out = []
        for a, b, s in self.edges:
            if a == i:
                out.append((b, s))
            elif b == i:
                out.append((a, s))
        return out

    def satisfies_rip(self) -> bool:
        """Running Intersection Property: for every pair of cliques, their
        intersection is contained in every clique on the path between them."""
        n = len(self.cliques)
        adj: Dict[int, List[int]] = {i: [] for i in range(n)}
        for a, b, _ in self.edges:
            adj[a].append(b)
            adj[b].append(a)

        def path(a: int, b: int) -> List[int]:
            prev = {a: a}
            stack = [a]
            while stack:
                u = stack.pop()
                if u == b:
                    break
                for w in adj[u]:
                    if w not in prev:
                        prev[w] = u
                        stack.append(w)
            out = [b]
            while out[-1] != a:
                out.append(prev[out[-1]])
            return out

        for i in range(n):
            for j in range(i + 1, n):
                inter = self.cliques[i] & self.cliques[j]
                if not inter:
                    continue
                for k in path(i, j):
                    if not inter <= self.cliques[k]:
                        return False
        return True


def junction_tree(maxcliques: List[FrozenSet[str]]) -> JunctionTree:
    """Maximal spanning tree over separator sizes (Kruskal)."""
    n = len(maxcliques)
    cand: List[Tuple[int, int, int]] = []
    for i in range(n):
        for j in range(i + 1, n):
            w = len(maxcliques[i] & maxcliques[j])
            if w > 0:
                cand.append((w, i, j))
    cand.sort(key=lambda t: (-t[0], t[1], t[2]))

    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges: List[Tuple[int, int, FrozenSet[str]]] = []
    for w, i, j in cand:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            edges.append((i, j, maxcliques[i] & maxcliques[j]))
    return JunctionTree(maxcliques, edges)


def is_chordal(adj: Dict[str, Set[str]]) -> bool:
    """Chordality check via a zero-fill min-fill sweep."""
    a = {v: set(ns) for v, ns in adj.items()}
    remaining = set(a.keys())
    while remaining:
        # find a simplicial vertex
        found = None
        for v in sorted(remaining):
            ns = [u for u in a[v] if u in remaining]
            ok = all(b in a[x] for i, x in enumerate(ns) for b in ns[i + 1:])
            if ok:
                found = v
                break
        if found is None:
            return False
        remaining.discard(found)
    return True
