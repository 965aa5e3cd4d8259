"""Algorithm 2 — building the GFJS *generator* via tweaked variable
elimination.

For every eliminated variable ``v`` the driver:

1. collects the factors containing ``v`` and multiplies them worst-case
   optimally (Algorithm 1 / ``multiway_product``) into ``phi_alpha``, keeping
   the bucket (original potentials) / fac (incoming messages) value split;
2. *conditionalizes* ``phi_alpha`` on v's parents — the separator, i.e. the
   remaining variables of ``phi_alpha`` — and stores the conditional factor
   ``psi(v | parents)`` (with its bucket and fac columns) into the generator,
   CSR-grouped by parent key for O(log) lookup at generation time;
3. sums ``v`` out to produce the message to the parents (frequencies of the
   sub-tree hanging below the separator).

Entries with zero frequency never exist (products only keep matching keys),
which is the paper's UIR-pruning argument: generation will never walk a path
that dies later, hence GJ is a WOJA.

Early projection (paper §3.7): variables not in the projection list are
eliminated first (O' before O) and step 2 is skipped for them ("the node is
deleted; the factor for its parent is still calculated").
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import QueryGraph, Triangulation, min_fill_order
from repro_torch.core.potentials import INT, Factor, _rank_rows
from repro_torch.core.potential_join import multiway_product
from repro_torch.obs.trace import span as _span
from repro_torch.relational.encoding import EncodedQuery


@dataclass
class Psi:
    """Conditional factor psi(child | parents), CSR-grouped by parent key."""

    child: str
    parents: Tuple[str, ...]
    parent_keys: np.ndarray    # [g, p] unique parent combos, lex-sorted
    start: np.ndarray          # [g] CSR start into child arrays
    count: np.ndarray          # [g]
    child_codes: np.ndarray    # [m]
    bucket: np.ndarray         # [m]
    fac: np.ndarray            # [m]
    parent_sizes: Tuple[int, ...]
    child_size: int

    @property
    def num_groups(self) -> int:
        return len(self.start)

    @property
    def num_entries(self) -> int:
        return len(self.child_codes)

    def nbytes(self) -> int:
        return int(self.parent_keys.nbytes + self.start.nbytes + self.count.nbytes
                   + self.child_codes.nbytes + self.bucket.nbytes + self.fac.nbytes)


@dataclass
class StepTrace:
    """Provenance + products of one elimination step (incremental refresh).

    ``rel_tables`` are indices into the per-occurrence table factors,
    ``rel_msgs`` the variables of earlier steps whose messages fed this
    product.  Both are *structural*: which factors contain a variable
    depends only on the query graph and the order, never on the data, so
    the same wiring can be replayed against updated factors.
    """

    var: str
    rel_tables: Tuple[int, ...]
    rel_msgs: Tuple[str, ...]
    parents: Tuple[str, ...]
    message: Factor
    psi: Optional[Psi]           # None for projected-out (O') variables


@dataclass
class EliminationTrace:
    """Everything a delta refresh needs to re-run only dirty steps."""

    steps: List[StepTrace]
    root_tables: Tuple[int, ...]       # table factors surviving to the root
    root_msgs: Tuple[str, ...]         # messages surviving to the root
    factors: List[Factor]              # per table occurrence, build order

    def nbytes(self) -> int:
        n = sum(f.keys.nbytes + f.bucket.nbytes + f.fac.nbytes
                for f in self.factors)
        for s in self.steps:
            n += int(s.message.keys.nbytes + s.message.bucket.nbytes
                     + s.message.fac.nbytes)
        return int(n)


@dataclass
class Generator:
    """The GFJS generator: root marginal + conditional factors by level.

    ``levels[d]`` holds the psis whose children sit at depth d+1 of the
    generator DAG (root = depth 0).  Children within one level are expanded
    jointly (Cartesian product semantics of the paper's Algorithm 4).
    """

    root: str
    root_codes: np.ndarray
    root_freq: np.ndarray
    levels: List[List[Psi]]
    elimination_order: List[str]
    column_order: List[str]      # root + level children, generation order
    join_size: int
    stats: Dict[str, float] = field(default_factory=dict)
    trace: Optional[EliminationTrace] = None   # set by record_trace builds
    # plan feedback: measured per-step elimination products and wall times
    # (var -> |multiway_product|, var -> seconds); the executor surfaces
    # these next to the planner's estimates in PhysicalPlan.explain()
    step_products: Dict[str, int] = field(default_factory=dict)
    step_seconds: Dict[str, float] = field(default_factory=dict)
    # variables whose psi/message were injected from the message cache
    # (their products were never computed; explain() renders cached=hit)
    cached_steps: Tuple[str, ...] = ()
    # hybrid plans: measured WCOJ bag products and wall times, keyed by
    # bag index in the plan's ``bags`` tuple (empty for pure-GJ builds)
    bag_products: Dict[int, int] = field(default_factory=dict)
    bag_seconds: Dict[int, float] = field(default_factory=dict)

    def nbytes(self) -> int:
        n = int(self.root_codes.nbytes + self.root_freq.nbytes)
        for lvl in self.levels:
            n += sum(p.nbytes() for p in lvl)
        return n


def _make_psi(phi: Factor, child: str, parents: Tuple[str, ...]) -> Psi:
    """Sort phi by (parents..., child) and CSR-group by parents."""
    f = phi.project(tuple(parents) + (child,))
    f = f.sort_by(list(parents) + [child])
    p = len(parents)
    pk = f.keys[:, :p]
    if f.num_entries == 0:
        return Psi(child, parents, pk[:0], np.zeros(0, INT), np.zeros(0, INT),
                   f.keys[:0, p], f.bucket[:0], f.fac[:0],
                   tuple(f.sizes[:p]), int(f.sizes[p]) if len(f.sizes) > p else 0)
    if p == 0:
        starts = np.zeros(1, INT)
        counts = np.array([f.num_entries], INT)
        upk = pk[:1]
    else:
        new = np.ones(f.num_entries, dtype=bool)
        new[1:] = np.any(pk[1:] != pk[:-1], axis=1)
        starts = np.flatnonzero(new).astype(INT)
        counts = np.diff(np.append(starts, f.num_entries)).astype(INT)
        upk = pk[starts]
    return Psi(child, parents, upk, starts, counts,
               f.keys[:, p].copy(), f.bucket.copy(), f.fac.copy(),
               tuple(f.sizes[:p]), int(f.sizes[p]))


def eliminate_step(
    rel: List[Factor], v: str, order: Sequence[str], out_vars: Sequence[str],
    observe: Optional[Dict[str, float]] = None,
) -> Tuple[Optional[Psi], Tuple[str, ...], Factor]:
    """One Algorithm-2 step: product, conditionalize, sum out.

    Returns ``(psi, parents, message)``; ``psi`` is None for projected-out
    variables.  Shared between the full build and the incremental refresher
    (which replays exactly this computation for dirty steps).

    ``observe`` (a dict, when given) receives ``product_entries`` — the
    measured size of the step's multiway product, the quantity the cost
    model estimates when scoring orders.
    """
    # Bind v FIRST in the frontier: every rel factor contains v, so each
    # later variable joins through it and prefix frontiers stay within
    # the pairwise-product bounds anchored at v.  Binding v last lets a
    # star of factors around v go cartesian over the satellite
    # variables before v prunes them (observed 100x+ slowdowns on
    # cyclic queries).  Output column order is (v, parents...) either
    # way downstream consumers re-sort.
    with _span(f"eliminate:{v}:product", cat="substep", var=v) as sp:
        phi_alpha = multiway_product(
            rel, var_order=[v] + [u for u in order if u != v])
        sp.set(entries=int(phi_alpha.num_entries))
    if observe is not None:
        observe["product_entries"] = float(phi_alpha.num_entries)
    parents = tuple(u for u in phi_alpha.vars if u != v)
    with _span(f"eliminate:{v}:marginal", cat="substep", var=v):
        psi = _make_psi(phi_alpha, v, parents) if v in out_vars else None
        msg = phi_alpha.marginalize_out(v)
    return psi, parents, msg


def root_marginal(factors: List[Factor], root: str) -> Factor:
    """Product of the factors surviving to the root (all over ``root``)."""
    for f in factors:
        if tuple(f.vars) != (root,):  # pragma: no cover - invariant
            raise AssertionError(f"leftover factor over {f.vars} at root")
    phi_root = factors[0]
    for f in factors[1:]:
        phi_root = phi_root.multiply(f)
    return phi_root.sort_by([root])


def assemble_generator(
    order: Sequence[str],
    psis: Dict[str, Psi],
    parents_of: Dict[str, Tuple[str, ...]],
    phi_root: Factor,
    stats: Dict[str, float],
    trace: Optional[EliminationTrace] = None,
    step_products: Optional[Dict[str, int]] = None,
    step_seconds: Optional[Dict[str, float]] = None,
) -> Generator:
    """Depth-level the psis under the root marginal into a Generator.

    Pure assembly (no data work): the refresher calls this with a mix of
    reused and recomputed psis to rebuild the generator after a delta.
    """
    root = order[-1]
    join_size = int(np.sum(phi_root.bucket * phi_root.fac))

    # depth levels of the generator DAG
    depth: Dict[str, int] = {root: 0}
    for v in reversed(list(order[:-1])):
        if v in psis:
            ps = parents_of[v]
            depth[v] = 1 + max((depth[p] for p in ps), default=0)
    max_depth = max(depth.values(), default=0)
    levels: List[List[Psi]] = [[] for _ in range(max_depth)]
    order_index = {v: i for i, v in enumerate(order)}
    for v in sorted(psis, key=lambda u: (depth[u], order_index[u])):
        levels[depth[v] - 1].append(psis[v])

    column_order = [root] + [p.child for lvl in levels for p in lvl]

    return Generator(
        root=root,
        root_codes=phi_root.keys[:, 0].copy(),
        root_freq=(phi_root.bucket * phi_root.fac).astype(INT),
        levels=levels,
        elimination_order=list(order),
        column_order=column_order,
        join_size=join_size,
        stats=stats,
        trace=trace,
        step_products=dict(step_products or {}),
        step_seconds=dict(step_seconds or {}),
    )


def build_generator(
    enc: EncodedQuery,
    *,
    elimination_order: Optional[Sequence[str]] = None,
    early_projection: bool = True,
    factors: Optional[List[Factor]] = None,
    record_trace: bool = False,
    step_estimates: Optional[Dict[str, float]] = None,
    bags: Optional[Sequence] = None,
    bag_estimates: Optional[Dict[int, float]] = None,
    message_cache=None,
    step_fingerprints: Optional[Dict[str, str]] = None,
    step_sources: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> Generator:
    """Run Algorithm 2 over the (possibly cyclic) query graph.

    ``factors``: pre-built quantitative-learning potentials (one per table
    occurrence, in ``enc.encoded_tables`` order).  The planner builds them
    for its statistics; passing them here avoids a second GROUP BY pass.

    ``record_trace`` keeps per-step provenance and messages on the returned
    generator (``Generator.trace``) so a later base-table append can re-run
    only the dirty steps (repro/summary/incremental.py).

    ``step_estimates`` (var -> planner product-entry estimate) annotates
    each step's trace span with est-vs-actual drift — the raw signal the
    CostModel feedback loop consumes.  Purely observational.

    ``bags`` (hypertree-decomposed hybrid plans): WCOJ multiway bag steps
    (``plan.ir.BagStep``) covering the cyclic core.  Each bag's table
    occurrences are generic-joined into one joint potential *before*
    elimination starts; the elimination loop then runs over bag potentials
    plus the unbagged table factors.  Because every bag scope is a clique
    of the chosen order's triangulation, the per-variable separators — and
    hence the GFJS — are bit-identical to the pure-GJ build.
    ``bag_estimates`` (bag index -> planner entry estimate) annotates the
    bag spans with est-vs-actual drift, like ``step_estimates``.

    ``message_cache`` (repro/summary/msgcache.py::MessageCache) with
    ``step_fingerprints`` (var -> subtree fingerprint, from
    ``plan.ir.step_fingerprints``) enables cross-query message reuse:
    before each step the cache is probed under single-flight — a hit
    injects the cached psi/message (positionally renamed to this build's
    separator) and skips the product + marginalization entirely; a miss
    computes, then puts (``step_sources`` names the base tables per step
    for explicit invalidation).  Reuse is refused for ``record_trace``
    builds (the trace owns its messages' provenance for incremental
    refresh) and for bagged plans (bag potentials merge occurrences
    outside the fingerprint's step wiring) — the cache is simply bypassed.
    Every probe emits a ``msg:<fingerprint>`` span annotated with the
    hit/miss outcome (validated by ``repro.obs.check``).
    """
    query = enc.query
    sizes = enc.domain_sizes()

    graph = QueryGraph.from_query(query)
    if not graph.is_connected():
        raise ValueError(
            f"query {query.name!r} has a disconnected join graph (cross product)")

    out_vars = list(query.output_variables)
    if not out_vars:
        raise ValueError("projection list must be non-empty")
    non_out = [v for v in graph.variables if v not in out_vars] if early_projection else []

    tri: Triangulation = min_fill_order(
        graph, first=non_out,
        forced_order=elimination_order,
    )
    order = tri.order

    # quantitative learning: one GROUP BY per table occurrence (unless the
    # planner already built the potentials for its statistics)
    if factors is None:
        factors = [Factor.from_columns(enc_cols, sizes)
                   for enc_cols in enc.encoded_tables]
    else:
        factors = list(factors)

    if order[-1] not in out_vars:  # root must be an output var (O' precedes O)
        raise AssertionError("root is a projected-out variable")

    psis: Dict[str, Psi] = {}
    parents_of: Dict[str, Tuple[str, ...]] = {}
    trace_steps: List[StepTrace] = []
    step_products: Dict[str, int] = {}
    step_seconds: Dict[str, float] = {}
    bag_products: Dict[int, int] = {}
    bag_seconds: Dict[int, float] = {}

    # the working set carries provenance tags: ("table", occurrence index)
    # for quantitative-learning factors, ("msg", var) for messages — which
    # is exactly the wiring an incremental refresh replays
    working: List[Tuple[str, object, Factor]] = [
        ("table", i, f) for i, f in enumerate(factors)]

    if bags:
        if record_trace:
            raise ValueError(
                "record_trace is unsupported for hypertree-decomposed (bagged) "
                "plans: bag potentials merge several table occurrences, which "
                "breaks the per-occurrence wiring incremental refresh replays; "
                "build with hybrid=False to record a trace")
        seen: set = set()
        for bag in bags:
            for i in bag.occurrences:
                if not 0 <= i < len(factors):
                    raise ValueError(
                        f"bag occurrence index {i} out of range "
                        f"(query has {len(factors)} table occurrences)")
                if i in seen:
                    raise ValueError(
                        f"table occurrence {i} appears in more than one bag")
                seen.add(i)
        working = [t for t in working if t[1] not in seen]
        for j, bag in enumerate(bags):
            label = ",".join(bag.vars)
            with _span(f"eliminate:bag[{label}]", cat="step", bag=j) as sp:
                t_bag = time.perf_counter()
                phi = multiway_product(
                    [factors[i] for i in bag.occurrences],
                    var_order=list(bag.bind_order))
                bag_seconds[j] = time.perf_counter() - t_bag
                bag_products[j] = int(phi.num_entries)
                sp.set(product=bag_products[j], seconds=bag_seconds[j])
                est = None
                if bag_estimates is not None and j in bag_estimates:
                    est = float(bag_estimates[j])
                elif getattr(bag, "est_entries", 0.0):
                    est = float(bag.est_entries)
                if est is not None:
                    sp.set(est=est,
                           drift=(bag_products[j] / est if est > 0.0
                                  else float("inf")))
            working.append(("bag", j, phi))

    # cross-query message reuse: refused under record_trace (the trace owns
    # its messages' provenance) and for bagged plans (bag potentials merge
    # occurrences outside the fingerprint's step wiring)
    use_cache = (message_cache is not None and step_fingerprints
                 and not record_trace and not bags)
    cached_steps: List[str] = []

    for v in order[:-1]:
        rel = [t for t in working if v in t[2].vars]
        rest = [t for t in working if v not in t[2].vars]
        if not rel:  # pragma: no cover - connected graph invariant
            raise AssertionError(f"no factor contains variable {v}")
        fp = step_fingerprints.get(v) if use_cache else None
        flight = None
        if fp is not None:
            with _span(f"msg:{fp[:16]}", cat="msgcache", var=v) as msp:
                t_step = time.perf_counter()
                entry, flight = message_cache.lookup_or_begin(fp)
                msp.set(hit=entry is not None)
                if entry is not None:
                    scope: set = set()
                    for _, _, f in rel:
                        scope.update(f.vars)
                    parents = tuple(
                        u for u in order if u != v and u in scope)
                    psi, msg = message_cache.adopt(entry, v, parents)
                    step_seconds[v] = time.perf_counter() - t_step
            if entry is not None:
                parents_of[v] = parents
                if psi is not None:
                    psis[v] = psi
                cached_steps.append(v)
                working = rest + [("msg", v, msg)]
                continue
        try:
            with _span(f"eliminate:{v}", cat="step", var=v) as sp:
                t_step = time.perf_counter()
                obs: Dict[str, float] = {}
                psi, parents, msg = eliminate_step(
                    [f for _, _, f in rel], v, order, out_vars, observe=obs)
                step_seconds[v] = time.perf_counter() - t_step
                step_products[v] = int(obs.get("product_entries", 0))
                sp.set(product=step_products[v], seconds=step_seconds[v])
                if step_estimates is not None and v in step_estimates:
                    est = float(step_estimates[v])
                    sp.set(est=est,
                           drift=(step_products[v] / est if est > 0.0
                                  else float("inf")))
        except BaseException:
            if fp is not None:
                message_cache.abandon(fp, flight)
            raise
        if fp is not None:
            message_cache.publish(
                fp, flight, psi, msg,
                tables=(step_sources or {}).get(v, ()))
        parents_of[v] = parents
        if psi is not None:
            psis[v] = psi
        if record_trace:
            trace_steps.append(StepTrace(
                var=v,
                rel_tables=tuple(r for k, r, _ in rel if k == "table"),
                rel_msgs=tuple(r for k, r, _ in rel if k == "msg"),
                parents=parents,
                message=msg,
                psi=psi,
            ))
        working = rest + [("msg", v, msg)]

    # root: product of the remaining factors (all over the root only)
    phi_root = root_marginal([f for _, _, f in working], order[-1])

    trace = None
    if record_trace:
        trace = EliminationTrace(
            steps=trace_steps,
            root_tables=tuple(r for k, r, _ in working if k == "table"),
            root_msgs=tuple(r for k, r, _ in working if k == "msg"),
            factors=list(factors),
        )

    gen = assemble_generator(
        order, psis, parents_of, phi_root,
        stats={
            "num_fill_edges": float(len(tri.fill_edges)),
            "num_maxcliques": float(len(tri.maxcliques)),
            "largest_maxclique": float(max((len(c) for c in tri.maxcliques), default=0)),
            "num_bags": float(len(bags) if bags else 0),
        },
        trace=trace,
        step_products=step_products,
        step_seconds=step_seconds,
    )
    gen.bag_products = bag_products
    gen.bag_seconds = bag_seconds
    gen.cached_steps = tuple(cached_steps)
    return gen
