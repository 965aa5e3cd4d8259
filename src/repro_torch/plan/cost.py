"""Cost model: score an elimination order by simulating Algorithm 2 on stats.

For every eliminated variable the real driver multiplies the factors that
contain it (`multiway_product`) and sums the variable out.  The dominant
cost of a step is the entry count of that product — both the expansion work
and the memory of the conditional factor stored into the generator.  The
model replays the same factor bookkeeping on :class:`FactorStats` instead of
data:

* joining two stat-factors that share a variable with degree vectors on
  both sides uses the **exact** pairwise product size (dot product of the
  degree vectors) — this is what sees skew;
* additional shared variables apply the standard independence correction
  ``1 / max(distinct_l, distinct_r)``;
* summing a variable out caps the message size at the product of the
  remaining variables' distinct counts (a separator-size / width bound in
  the hypertree-duality sense: the separator is the clique the message
  lives on).

``simulate`` returns the per-step estimates and their sum — the plan cost.
Estimates are heuristic; correctness never depends on them (every
admissible order yields the same GFJS; see tests/test_plan.py).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.plan.stats import FactorStats, QueryStats

_HUGE = 1e30
# vertex-enumeration budget for the exact fractional-edge-cover LP; past
# this many basis candidates the greedy integral cover takes over
_LP_COMBO_CAP = 5000
# what a message-cache hit costs in product-entry units: a key probe plus a
# positional rename, independent of how expensive the skipped product was
CACHED_STEP_COST = 1.0


@dataclass
class StepEstimate:
    """Planner's view of one elimination step."""

    var: str
    product_entries: float          # estimated |multiway_product(rel)|
    separator: Tuple[str, ...]      # remaining vars of the product
    message_entries: float          # estimated message size after summing out
    num_factors: int                # how many factors contained the var
    tables: Tuple[str, ...] = ()    # base tables feeding the step (transitive)
    cached: bool = False            # message resident in the cache at plan time

    @property
    def cost(self) -> float:
        return CACHED_STEP_COST if self.cached else self.product_entries


def _join_stats(a: FactorStats, b: FactorStats) -> FactorStats:
    """Estimated stats of the factor product a ⋈ b.

    Deliberately conservative: the estimate is the *minimum single-variable
    bound* — for each shared variable the dot product of the degree vectors
    (the exact product size if that were the only join variable), taking
    the tightest one.  Further shared variables only shrink the true
    result, but applying independence corrections for them systematically
    underestimates correlated intermediates (messages in a cyclic query are
    highly correlated), and an optimistic planner is a dangerous planner:
    one missed blow-up costs more than many slightly-loose bounds.
    """
    shared = [v for v in a.vars if v in b.vars]
    out_vars = a.vars + tuple(v for v in b.vars if v not in a.vars)

    if not shared:
        entries = min(a.entries * b.entries, _HUGE)
    else:
        bounds = [float(a.degrees[v] @ b.degrees[v]) for v in shared
                  if a.has_degrees(v) and b.has_degrees(v)]
        # containment: if one side's variables are a subset of the other's,
        # every result row extends exactly one row of the superset side
        # (factor keys are unique), so the superset's cardinality bounds
        # the product — this is what keeps same-separator message products
        # (cyclic queries) from looking like cartesian blow-ups.
        if set(a.vars) <= set(b.vars):
            bounds.append(b.entries)
        if set(b.vars) <= set(a.vars):
            bounds.append(a.entries)
        if not bounds:
            # scalar fallback: one correction by the most selective variable
            sel = max(max(a.distinct.get(v, 1.0), b.distinct.get(v, 1.0), 1.0)
                      for v in shared)
            bounds = [a.entries * b.entries / sel]
        entries = min(min(bounds), _HUGE)

    distinct: Dict[str, float] = {}
    degrees: Dict[str, np.ndarray] = {}
    for v in out_vars:
        cands = [s.distinct[v] for s in (a, b) if v in s.distinct]
        distinct[v] = min(min(cands), max(entries, 1.0))
        if v in shared and a.has_degrees(v) and b.has_degrees(v):
            degrees[v] = a.degrees[v] * b.degrees[v]
        elif a.has_degrees(v):
            degrees[v] = a.degrees[v] * (entries / max(a.entries, 1.0))
        elif b.has_degrees(v):
            degrees[v] = b.degrees[v] * (entries / max(b.entries, 1.0))
    return FactorStats(out_vars, entries, distinct, degrees,
                       a.sources | b.sources)


def _sum_out(joint: FactorStats, var: str) -> FactorStats:
    """Estimated stats of the message after marginalizing ``var`` out."""
    keep = tuple(v for v in joint.vars if v != var)
    cap = 1.0
    for v in keep:
        cap = min(cap * max(joint.distinct.get(v, 1.0), 1.0), _HUGE)
    entries = min(joint.entries, cap) if keep else 1.0
    scale = entries / max(joint.entries, 1.0)
    distinct = {v: min(joint.distinct[v], max(entries, 1.0)) for v in keep}
    degrees = {v: joint.degrees[v] * scale
               for v in keep if v in joint.degrees}
    return FactorStats(keep, entries, distinct, degrees, joint.sources)


def fractional_edge_cover(variables: Sequence[str],
                          scopes: Sequence[Set[str]],
                          log_sizes: Sequence[float]
                          ) -> Tuple[float, float]:
    """The AGM fractional-edge-cover LP over a bag's factors.

    minimize  sum_f x_f * log N_f
    s.t.      sum_{f : v in scope(f)} x_f >= 1   for every v in variables
              x >= 0

    Returns ``(rho, log_bound)``: the cover weight at the optimum and the
    optimal objective — ``exp(log_bound)`` is the AGM bound on the bag's
    join size (and, by restriction of the same cover, on every prefix
    frontier of a WCOJ evaluation of the bag).

    Solved exactly by basic-feasible-point enumeration (an LP optimum sits
    on a vertex: n tight constraints out of the m coverage + n
    nonnegativity rows); bags are small, so the combinatorics stay tiny —
    past ``_LP_COMBO_CAP`` candidates a greedy integral set cover takes
    over (a valid, merely looser, cover).
    """
    n = len(scopes)
    vs = [v for v in variables if any(v in s for s in scopes)]
    m = len(vs)
    if n == 0 or m == 0:
        return 0.0, 0.0
    A = np.zeros((m, n))
    for j, sc in enumerate(scopes):
        for i, v in enumerate(vs):
            if v in sc:
                A[i, j] = 1.0
    c = np.asarray([max(w, 0.0) for w in log_sizes], float)
    rows = [(A[i], 1.0) for i in range(m)]
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        rows.append((e, 0.0))
    best_val, best_rho = None, 0.0
    if math.comb(m + n, n) <= _LP_COMBO_CAP:
        for combo in itertools.combinations(range(m + n), n):
            M = np.stack([rows[k][0] for k in combo])
            b = np.asarray([rows[k][1] for k in combo])
            try:
                x = np.linalg.solve(M, b)
            except np.linalg.LinAlgError:
                continue
            if (x >= -1e-9).all() and (A @ x >= 1.0 - 1e-9).all():
                val = float(c @ x)
                if best_val is None or val < best_val - 1e-12:
                    best_val, best_rho = val, float(x.sum())
    if best_val is None:
        # greedy integral cover: most uncovered vars per unit log-size
        uncovered = set(vs)
        val, rho = 0.0, 0.0
        while uncovered:
            j = max(range(n),
                    key=lambda k: (len(scopes[k] & uncovered), -c[k], -k))
            if not scopes[j] & uncovered:  # pragma: no cover - cover invariant
                break
            uncovered -= scopes[j]
            val += float(c[j])
            rho += 1.0
        best_val, best_rho = val, rho
    return best_rho, best_val


@dataclass
class BagEstimate:
    """Planner's view of one WCOJ bag step (see plan/ir.py::BagStep)."""

    entries: float              # estimated |bag product| (final frontier)
    cost: float                 # estimated work: sum of per-level frontiers
    rho: float                  # fractional edge cover number of the bag
    agm_entries: float          # AGM bound exp(sum x_f log N_f)
    stats: FactorStats          # the bag product as a spine-level factor


class CostModel:
    """Scores elimination orders on a query's :class:`QueryStats`.

    ``corrections`` (op name -> scalar) are the calibration factors from
    :meth:`calibrate`: estimates for an op are multiplied by its factor,
    so a model fed past drift records prices the next plan with them.
    """

    def __init__(self, stats: QueryStats,
                 corrections: Optional[Mapping[str, float]] = None) -> None:
        self.stats = stats
        self.corrections = dict(corrections or {})

    def _corr(self, op: str) -> float:
        return float(self.corrections.get(op, 1.0))

    def initial_factors(self) -> List[FactorStats]:
        return list(self.stats.factor_stats)

    def eliminate(self, factors: List[FactorStats], var: str
                  ) -> Tuple[StepEstimate, List[FactorStats]]:
        """One simulated elimination step: returns (estimate, new factors)."""
        rel = [f for f in factors if var in f.vars]
        rest = [f for f in factors if var not in f.vars]
        if not rel:
            est = StepEstimate(var, 0.0, (), 0.0, 0)
            return est, rest
        joint = rel[0]
        for f in rel[1:]:
            joint = _join_stats(joint, f)
        msg = _sum_out(joint, var)
        est = StepEstimate(var,
                           min(joint.entries * self._corr("eliminate"), _HUGE),
                           msg.vars, msg.entries, len(rel),
                           tuple(sorted(joint.sources)))
        return est, rest + [msg]

    def step_cost(self, factors: List[FactorStats], var: str) -> float:
        """Cost of eliminating ``var`` next, without committing the step."""
        return self.eliminate(factors, var)[0].cost

    def simulate(self, order: Sequence[str],
                 factors: Optional[Sequence[FactorStats]] = None
                 ) -> Tuple[List[StepEstimate], float]:
        """Replay a full order; returns per-step estimates and total cost.

        The last variable of the order is the generator root — it is never
        eliminated, so it contributes no step.  ``factors`` replaces the
        initial working set (the hybrid planner passes bag-product stats
        plus the unbagged table factors to price the acyclic spine).
        """
        factors = self.initial_factors() if factors is None else list(factors)
        steps: List[StepEstimate] = []
        for v in list(order)[:-1]:
            est, factors = self.eliminate(factors, v)
            steps.append(est)
        return steps, float(sum(s.cost for s in steps))

    def apply_residency(self, steps: Sequence[StepEstimate],
                        cached_vars: Set[str]
                        ) -> Tuple[Tuple[StepEstimate, ...], float]:
        """Reprice steps whose message is already resident in the message
        cache: a cached step costs :data:`CACHED_STEP_COST` (a key lookup)
        no matter how expensive the skipped product would have been.
        Returns the repriced steps and the adjusted total — what the order
        search compares so it can prefer orders that maximize reusable
        prefixes against the cache's resident key set."""
        out = tuple(replace(s, cached=True) if s.var in cached_vars else s
                    for s in steps)
        return out, float(sum(s.cost for s in out))

    # -- WCOJ bag steps ----------------------------------------------------
    def bag_estimate(self, occurrences: Sequence[int],
                     bind_order: Sequence[str]) -> BagEstimate:
        """Price a WCOJ bag step joining the given table occurrences.

        Two bounds, combined take the min at every level:

        * **AGM** — ``fractional_edge_cover`` over the bag's factors.  The
          optimal cover restricted to a prefix of ``bind_order`` is
          feasible for the prefix LP with the same objective, so the full
          bound caps every intermediate frontier, not just the output.
        * **skew-aware level simulation** — fold the frontier through
          ``_join_stats`` one bind level at a time, expanding through the
          cheapest containing factor (mirroring the real
          ``multiway_product`` expander choice) and projecting away
          unbound variables; this is what sees degree skew the AGM bound
          is blind to.

        ``cost`` sums the per-level frontiers (the work the breadth-first
        WCOJ actually does); ``entries`` is the final frontier (what the
        executor's bag span measures, the drift anchor).
        """
        stats = [self.stats.factor_stats[i] for i in occurrences]
        scopes = [set(s.vars) for s in stats]
        logs = [math.log(max(s.entries, 1.0)) for s in stats]
        rho, logb = fractional_edge_cover(bind_order, scopes, logs)
        agm = min(math.exp(min(logb, math.log(_HUGE))), _HUGE)

        def _cap(f: FactorStats) -> FactorStats:
            if f.entries <= agm:
                return f
            scale = agm / max(f.entries, 1.0)
            return FactorStats(f.vars, agm,
                               {u: min(d, agm) for u, d in f.distinct.items()},
                               {u: d * scale for u, d in f.degrees.items()},
                               f.sources)

        frontier: Optional[FactorStats] = None
        bound: List[str] = []
        cost = 0.0
        for v in bind_order:
            rel = [s for s in stats if v in s.vars]
            if not rel:
                bound.append(v)
                continue
            best: Optional[FactorStats] = None
            for s in rel:
                j = s if frontier is None else _join_stats(frontier, s)
                for u in list(j.vars):
                    if u != v and u not in bound:
                        j = _sum_out(j, u)
                if best is None or j.entries < best.entries:
                    best = j
            frontier = _cap(best)
            bound.append(v)
            cost += frontier.entries
        if frontier is None:  # pragma: no cover - bags always bind a var
            frontier = FactorStats(tuple(bind_order), 0.0, {}, {}, set())
        corr = self._corr("bag")
        sources: Set[str] = set()
        for s in stats:
            sources |= s.sources
        out = FactorStats(frontier.vars, frontier.entries, dict(frontier.distinct),
                          dict(frontier.degrees), sources)
        return BagEstimate(entries=min(out.entries * corr, _HUGE),
                           cost=min(cost * corr, _HUGE),
                           rho=rho, agm_entries=agm, stats=out)

    # -- calibration (the first bite of the plan-feedback control half) ----
    @staticmethod
    def drift_factor(estimates: Mapping[str, float],
                     actuals: Mapping[str, float]) -> float:
        """Geometric-mean actual/estimate ratio over the common keys.

        The geometric mean is the right pooling for multiplicative drift:
        one 100x blow-up and one 100x overestimate cancel, and the result
        is scale-free in the step sizes.  Keys with a nonpositive side are
        skipped (an empty product carries no ratio information).
        """
        logs = [math.log(float(actuals[k]) / float(estimates[k]))
                for k in estimates
                if k in actuals
                and float(estimates[k]) > 0.0 and float(actuals[k]) > 0.0]
        if not logs:
            return 1.0
        return float(math.exp(sum(logs) / len(logs)))

    def calibrate(self, step_estimates: Mapping[str, float],
                  step_actuals: Mapping[str, float],
                  bag_estimates: Optional[Mapping[object, float]] = None,
                  bag_actuals: Optional[Mapping[object, float]] = None
                  ) -> Dict[str, float]:
        """Fold measured drift records into per-op correction factors.

        Consumes the PR-5 feedback surface (``Generator.step_products``
        vs the plan's ``StepEstimate.product_entries``, and the bag
        equivalents) and stores one scalar per op kind: ``"eliminate"``
        for spine steps, ``"bag"`` for WCOJ bag products.  Subsequent
        :meth:`eliminate`/:meth:`bag_estimate` calls on THIS model price
        with the corrections; the returned dict is what
        ``explain(analyze=True)`` renders as calibrated-vs-raw.
        """
        if step_estimates and step_actuals:
            self.corrections["eliminate"] = self.drift_factor(
                step_estimates, step_actuals)
        if bag_estimates and bag_actuals:
            self.corrections["bag"] = self.drift_factor(
                {str(k): v for k, v in bag_estimates.items()},
                {str(k): v for k, v in bag_actuals.items()})
        return dict(self.corrections)
