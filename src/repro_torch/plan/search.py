"""Elimination-order search: min-fill joins a candidate pool it used to own.

``plan_query`` builds the LogicalPlan (graph + projection split + stats),
generates candidate orders, scores each with the :class:`CostModel`, and
pins the winner into a :class:`PhysicalPlan`:

* **min_fill**  — the paper's structural heuristic (always in the pool, so
  the planner can never regress below the old behavior *by its own
  estimate*);
* **greedy**    — pick the cheapest next variable by simulated step cost
  (skew-aware through the degree vectors);
* **beam**      — width-``beam_width`` search over prefixes ranked by
  accumulated step cost.

Admissibility (what `build_generator` requires) is enforced structurally:
projected-out variables (O') are eliminated before output variables (O),
so the root — the last variable — is always an output variable.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import (QueryGraph, decompose_bags, min_fill_order,
                              structurally_acyclic)
from repro_torch.obs.trace import span as _span
from repro_torch.plan.cost import CostModel
from repro_torch.plan.ir import BagStep, LogicalPlan, OrderCandidate, PhysicalPlan
from repro_torch.plan.stats import QueryStats
from repro_torch.relational.encoding import EncodedQuery

STREAM_THRESHOLD = 60_000_000  # est rows above which desummarize streams


def build_logical_plan(enc: EncodedQuery, *,
                       early_projection: bool = True,
                       stats: Optional[QueryStats] = None) -> LogicalPlan:
    query = enc.query
    graph = QueryGraph.from_query(query)
    out_vars = tuple(query.output_variables)
    projected_out = tuple(v for v in graph.variables if v not in out_vars) \
        if early_projection else ()
    if stats is None:
        with _span("plan:stats", cat="plan",
                   rows=sum(len(next(iter(cols.values()), ()))
                            for cols in enc.encoded_tables)):
            stats = QueryStats.of(enc)
    return LogicalPlan(query, graph, out_vars, projected_out, stats)


def _pool(remaining: List[str], first_set: frozenset) -> List[str]:
    """Eligible next variables: O' while any remain, then O."""
    early = [v for v in remaining if v in first_set]
    return early if early else remaining


def greedy_order(model: CostModel, variables: Sequence[str],
                 first: Sequence[str]) -> Tuple[str, ...]:
    """Cheapest-next-step order (ties break by name for determinism)."""
    first_set = frozenset(first)
    remaining = list(variables)
    factors = model.initial_factors()
    order: List[str] = []
    while remaining:
        pool = _pool(remaining, first_set)
        if len(remaining) == 1:
            v = remaining[0]
        else:
            v = min(pool, key=lambda u: (model.step_cost(factors, u), u))
        est, factors = model.eliminate(factors, v)
        remaining.remove(v)
        order.append(v)
    return tuple(order)


def beam_orders(model: CostModel, variables: Sequence[str],
                first: Sequence[str], *, beam_width: int = 4
                ) -> List[Tuple[str, ...]]:
    """Beam search over elimination prefixes; returns ranked full orders."""
    first_set = frozenset(first)
    # state: (accumulated cost, order-so-far, remaining, sim factors)
    states = [(0.0, (), tuple(variables), model.initial_factors())]
    n = len(variables)
    for depth in range(n):
        nxt = []
        for cost, order, remaining, factors in states:
            pool = _pool(list(remaining), first_set)
            for v in pool:
                est, nf = model.eliminate(factors, v)
                step = est.cost if depth < n - 1 else 0.0  # root is free
                nxt.append((cost + step, order + (v,),
                            tuple(u for u in remaining if u != v), nf))
        nxt.sort(key=lambda s: (s[0], s[1]))
        states = nxt[:max(beam_width, 1)]
    return [s[1] for s in states]


def _select_backends() -> Dict[str, str]:
    """Phase -> engine: both device phases run on the torch engine.

    Keys pinned here are the ones the executor consults: "summarize" picks
    the generation engine — numpy (the dynamic-shape oracle) or the
    device-resident ``core/engine.py::generate_gfjs`` frontier — and
    "desummarize" the expansion engine.  Where the torch engine runs (a
    card, or the CPU with the plain kernel versions) is the executor's
    explicit ``device``, not a plan choice.
    """
    return {"summarize": "torch", "desummarize": "torch"}


def propose_decomposition(
        model: CostModel, logical: LogicalPlan, order: Sequence[str]
) -> Tuple[Tuple[BagStep, ...], List, float]:
    """Hypertree-decomposed hybrid candidate for ``order`` (cyclic only).

    Covers the table occurrences with cliques of the order's induced
    triangulation (``core/graph.py::decompose_bags``), prices each
    multi-occurrence bag as a WCOJ step (AGM bound + skew-aware level
    simulation, ``CostModel.bag_estimate``), then simulates the remaining
    acyclic spine — ordinary GJ elimination over the bag marginals plus
    the unbagged table factors.  Returns ``(bags, spine_steps, total)``;
    ``bags`` is empty when the query is structurally acyclic (the gate
    that keeps acyclic signatures and cache keys byte-unchanged) or when
    no clique joins two or more occurrences.
    """
    graph = logical.graph
    if structurally_acyclic(graph):
        return (), [], 0.0
    raw, _tri = decompose_bags(graph, order)
    if not raw:
        return (), [], 0.0
    bag_steps: List[BagStep] = []
    bag_stats = []
    used = set()
    for scope, occs in raw:
        est = model.bag_estimate(occs, scope)
        bag_steps.append(BagStep(
            vars=tuple(scope), occurrences=tuple(occs),
            bind_order=tuple(scope),
            est_entries=est.entries, est_cost=est.cost,
            agm_entries=est.agm_entries, rho=est.rho,
            num_factors=len(occs),
            tables=tuple(sorted(est.stats.sources))))
        bag_stats.append(est.stats)
        used.update(occs)
    spine = bag_stats + [fs for i, fs in enumerate(model.initial_factors())
                         if i not in used]
    steps, spine_total = model.simulate(order, factors=spine)
    total = float(sum(b.est_cost for b in bag_steps)) + spine_total
    return tuple(bag_steps), steps, total


def plan_query(enc: EncodedQuery, *,
               elimination_order: Optional[Sequence[str]] = None,
               early_projection: bool = True,
               planner: str = "cost",
               beam_width: int = 4,
               stats: Optional[QueryStats] = None,
               generation_backend: Optional[str] = None,
               partitions: Optional[int] = None,
               partition_var: Optional[str] = None,
               partition_fold: Optional[int] = None,
               shard_executor: Optional[str] = None,
               hybrid: Optional[bool] = None,
               corrections: Optional[Dict[str, float]] = None,
               message_cache=None,
               table_versions: Optional[Dict[str, str]] = None
               ) -> Tuple[LogicalPlan, PhysicalPlan]:
    """Logical + physical plan for an encoded query.

    ``elimination_order`` forces the order (source="forced");
    ``planner="min_fill"`` restores the pre-planner behavior;
    ``planner="cost"`` runs the candidate search.
    ``generation_backend`` pins the GFJS-generation engine ("numpy" — the
    dynamic-shape oracle — or "torch", the device-resident frontier) instead
    of the default; per-query pinning because small or irregular
    generators favor numpy even when an accelerator is present.
    ``partitions`` > 1 pins hash-partitioned execution
    (repro/dist/partition.py): the executor splits the encoded potentials
    into that many shards on ``partition_var`` (default: the eliminated
    variable of the costliest estimated step, discounted by key skew) and
    runs the shards independently, producing a ``ShardedGFJS``.
    ``shard_executor`` picks where shard pipelines run: ``"thread"``
    (default) or ``"process"`` — the repro/dist/actions.py worker pool.
    ``partition_fold`` over-partitions into ``partitions * fold`` virtual
    shards folded back onto ``partitions`` workers (skew smoothing);
    default: auto-chosen from the degree stats (1 when balanced).
    ``hybrid`` controls hypertree-decomposed GJ/WCOJ execution on cyclic
    queries: ``None`` (default) lets the cost model choose between the
    hybrid candidate and pure GJ, ``False`` disables the candidate, and
    ``True`` forces it (raising when the query is structurally acyclic —
    there is no decomposition to force).  Acyclic queries are never
    decomposed, so their plan signatures and cache keys are unchanged.
    ``corrections`` seeds the CostModel with persisted calibration factors
    (op -> scalar; see ``CostModel.calibrate`` and the JoinService
    sidecar).  ``message_cache`` + ``table_versions`` enable residency
    pricing: steps whose subtree fingerprint is already resident in the
    message cache are priced at ~lookup cost (`CostModel.apply_residency`)
    and ties break toward orders that maximize reusable steps — so a warm
    cache steers the search toward the shared prefix.  Monolithic plans
    only; partitioned builds cannot consume cached messages.
    """
    if generation_backend not in (None, "numpy", "torch"):
        raise ValueError(
            f"unknown generation backend {generation_backend!r}")
    partitions = 1 if partitions is None else int(partitions)
    if partitions < 1:
        raise ValueError(f"partitions must be >= 1, got {partitions}")
    if partitions == 1 and partition_var is not None:
        raise ValueError(
            f"partition_var={partition_var!r} requires partitions > 1 "
            "(a monolithic plan would silently ignore it)")
    if shard_executor not in (None, "thread", "process"):
        raise ValueError(f"unknown shard executor {shard_executor!r} "
                         "(have: thread, process)")
    if partitions == 1 and shard_executor is not None:
        raise ValueError(
            f"shard_executor={shard_executor!r} requires partitions > 1 "
            "(a monolithic plan would silently ignore it)")
    if partition_fold is not None:
        partition_fold = int(partition_fold)
        if partition_fold < 1:
            raise ValueError(
                f"partition_fold must be >= 1, got {partition_fold}")
        if partitions == 1 and partition_fold != 1:
            raise ValueError(
                f"partition_fold={partition_fold} requires partitions > 1 "
                "(a monolithic plan would silently ignore it)")
    if hybrid not in (None, True, False):
        raise ValueError(f"hybrid must be None, True, or False, got {hybrid!r}")
    if hybrid is True and partitions > 1:
        raise ValueError(
            "hybrid=True is unsupported with partitions > 1 (bag potentials "
            "are built monolithically; partition the pure-GJ plan instead)")
    t0 = time.perf_counter()
    with _span("plan:search", cat="plan", planner=planner):
        return _plan_query_inner(
            enc, t0, elimination_order=elimination_order,
            early_projection=early_projection, planner=planner,
            beam_width=beam_width, stats=stats,
            generation_backend=generation_backend,
            partitions=partitions, partition_var=partition_var,
            partition_fold=partition_fold, shard_executor=shard_executor,
            hybrid=hybrid, corrections=corrections,
            message_cache=message_cache, table_versions=table_versions)


def _plan_query_inner(enc: EncodedQuery, t0: float, *,
                      elimination_order, early_projection, planner,
                      beam_width, stats, generation_backend,
                      partitions, partition_var,
                      partition_fold=None, shard_executor=None,
                      hybrid=None, corrections=None,
                      message_cache=None, table_versions=None
                      ) -> Tuple[LogicalPlan, PhysicalPlan]:
    logical = build_logical_plan(enc, early_projection=early_projection,
                                 stats=stats)
    model = CostModel(logical.stats, corrections=corrections)
    graph, query = logical.graph, logical.query
    first = list(logical.projected_out)

    # residency pricing: which already-resident messages would each
    # candidate order reuse?  Fingerprints depend only on (order, versions,
    # encoding), so this is a pure plan-time computation.
    resident = None
    if (message_cache is not None and table_versions is not None
            and partitions == 1):
        keys = message_cache.resident_keys()
        resident = keys if keys else None

    def _residency(order: Sequence[str]) -> frozenset:
        if resident is None:
            return frozenset()
        from repro_torch.plan.ir import step_fingerprints
        fps, _ = step_fingerprints(
            enc, tuple(order), logical.output_vars, table_versions)
        return frozenset(v for v, fp in fps.items() if fp in resident)

    with _span("plan:orders", cat="plan") as sp:
        candidates: List[OrderCandidate] = []
        # order -> (repriced steps, adjusted total, #cached steps)
        sims: Dict[Tuple[str, ...], Tuple[Tuple, float, int]] = {}

        def score(source: str, order: Sequence[str]) -> OrderCandidate:
            order = tuple(order)
            if order not in sims:
                raw_steps, _ = model.simulate(order)
                cached = _residency(order)
                sims[order] = (*model.apply_residency(raw_steps, cached),
                               len(cached))
            return OrderCandidate(source, order, sims[order][1])

        if elimination_order is not None:
            chosen = score("forced", tuple(elimination_order))
            candidates.append(chosen)
        else:
            tri = min_fill_order(graph, first=first)
            candidates.append(score("min_fill", tri.order))
            if planner == "cost" and len(graph.variables) > 1:
                candidates.append(score(
                    "greedy", greedy_order(model, graph.variables, first)))
                for order in beam_orders(model, graph.variables, first,
                                         beam_width=beam_width)[:1]:
                    candidates.append(score("beam", order))
            # dedupe identical orders, keep first source naming it
            seen: Dict[Tuple[str, ...], OrderCandidate] = {}
            for c in candidates:
                seen.setdefault(c.order, c)
            candidates = list(seen.values())
            # ties break first toward MORE reusable (cached) steps, then
            # toward the paper's structural heuristic
            chosen = min(candidates,
                         key=lambda c: (c.cost, -sims[c.order][2],
                                        c.source != "min_fill"))

        steps, total, _ = sims[chosen.order]
        steps = list(steps)
        source = chosen.source

        # hypertree-decomposed hybrid candidate: WCOJ bag steps over the
        # cyclic core, GJ elimination over the bag marginals for the spine.
        # Gated to monolithic plans (bag potentials are built whole) and to
        # structurally cyclic queries (propose_decomposition returns no bags
        # otherwise, keeping acyclic signatures byte-unchanged).
        bags: Tuple[BagStep, ...] = ()
        if hybrid is not False and partitions == 1:
            cand_bags, cand_steps, cand_total = propose_decomposition(
                model, logical, chosen.order)
            if cand_bags:
                candidates = list(candidates) + [
                    OrderCandidate("hybrid", chosen.order, cand_total)]
                if hybrid is True or cand_total < total:
                    bags, steps, total = cand_bags, cand_steps, cand_total
                    source = "hybrid"
            elif hybrid is True:
                raise ValueError(
                    f"hybrid=True requires a structurally cyclic query; "
                    f"{query.name!r} admits no multiway bag (a pure-GJ plan "
                    "is already hypertree-optimal on acyclic queries)")
        sp.set(orders=len(sims))

    # distinct-key estimate only (a lower bound on materialized rows —
    # bucket/fac multiplicities are unknown at plan time); the executor
    # re-checks the exact join_size before materializing, so "inmem" here
    # is a hint, never a commitment to an in-memory blow-up
    est_rows = max((s.message_entries for s in steps), default=0.0)
    backends = _select_backends()
    if generation_backend is not None:
        backends["summarize"] = generation_backend
    if partitions > 1:
        from repro_torch.dist.partition import (choose_partition_fold,
                                                choose_partition_var)
        if partition_var is None:
            partition_var = choose_partition_var(
                steps, chosen.order, stats=logical.stats,
                partitions=partitions)
        elif partition_var not in graph.variables:
            raise ValueError(
                f"partition variable {partition_var!r} is not a query "
                f"variable (have: {sorted(graph.variables)})")
        if partition_fold is None:
            partition_fold = choose_partition_fold(
                logical.stats, partition_var, partitions)
    physical = PhysicalPlan(
        query_name=query.name,
        order=chosen.order,
        early_projection=early_projection,
        backends=backends,
        materialize="stream" if est_rows > STREAM_THRESHOLD else "inmem",
        source=source,
        est_cost=total,
        steps=tuple(steps),
        alternatives=tuple(sorted(candidates, key=lambda c: c.cost)),
        planner="forced" if elimination_order is not None else planner,
        search_seconds=time.perf_counter() - t0,
        partitions=partitions,
        partition_var=partition_var,
        partition_fold=partition_fold if partition_fold else 1,
        shard_executor=shard_executor if shard_executor else "thread",
        bags=bags,
    )
    return logical, physical
