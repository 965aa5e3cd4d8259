"""Algorithm 1 — worst-case-optimal join *of potentials* (not data).

The paper's Algorithm 1 recursively binds one variable at a time: for each
value shared by every potential containing the variable, it restricts those
potentials and recurses; at the leaves it multiplies entry frequencies
(Bucket_Product).  Depth-first per-value recursion is hostile to TPUs, so —
exactly like our Algorithm 3/4 treatment — we run the *level-synchronous*
(breadth-first) form: the frontier after binding variables v_1..v_i is the
set of all viable prefixes, computed with sorted-merge joins and semijoin
filters.  Each prefix frontier is bounded by the AGM bound of its prefix
query, so the total work stays O(M^rho) — the same worst-case-optimality
argument as the paper's.

The same routine drives (a) joint-potential construction for junction-tree
maxcliques and (b) the product step of Algorithm 2 when several factors
contain the variable being eliminated, and (c) the leapfrog baseline
(over row-level indicator factors).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.potentials import INT, Factor, _rank_rows


def distinct_projection(f: Factor, vars: Sequence[str]) -> Factor:
    """Distinct rows of f's projection onto ``vars`` (indicator factor)."""
    idx = [f.var_index(v) for v in vars]
    sub = f.keys[:, idx]
    sizes = tuple(f.sizes[i] for i in idx)
    if len(sub) == 0:
        return Factor(tuple(vars), sub, np.zeros(0, INT), np.zeros(0, INT), sizes)
    ranks, _ = _rank_rows(sub, sizes)
    order = np.argsort(ranks, kind="stable")
    sranks = ranks[order]
    new = np.ones(len(sranks), dtype=bool)
    new[1:] = sranks[1:] != sranks[:-1]
    starts = np.flatnonzero(new)
    u = sub[order][starts]
    ones = np.ones(len(u), INT)
    return Factor(tuple(vars), u, ones, ones, sizes)


def _match_indices(joint: Factor, f: Factor) -> np.ndarray:
    """For each joint row, the index of the matching row in f (grouped keys).

    f must have unique key rows over vars(f) (true for potentials).
    Rows with no match return -1.
    """
    fv = list(f.vars)
    ji = [joint.var_index(v) for v in fv]
    a = joint.keys[:, ji]
    b = f.keys
    sizes = [f.sizes[i] for i in range(len(fv))]
    from repro_torch.core.potentials import _rank_rows_joint

    (ra, rb), _ = _rank_rows_joint(a, b, sizes)
    order = np.argsort(rb, kind="stable")
    rb_sorted = rb[order]
    pos = np.searchsorted(rb_sorted, ra)
    pos = np.clip(pos, 0, max(len(rb_sorted) - 1, 0))
    ok = (len(rb_sorted) > 0) & (rb_sorted[pos] == ra) if len(rb_sorted) else np.zeros(len(ra), bool)
    out = np.where(ok, order[pos], -1)
    return out.astype(INT)


def multiway_product(
    factors: List[Factor],
    var_order: Optional[Sequence[str]] = None,
) -> Factor:
    """Join a set of potentials into one joint potential, worst-case optimally.

    Buckets multiply with buckets and facs with facs (provenance split
    preserved) — the Bucket_Product of the paper's Algorithm 1 line 11.
    """
    if len(factors) == 1:
        return factors[0]
    all_vars: List[str] = []
    for f in factors:
        for v in f.vars:
            if v not in all_vars:
                all_vars.append(v)
    order = [v for v in (var_order or all_vars) if v in all_vars]
    for v in all_vars:
        if v not in order:
            order.append(v)

    # beyond-paper optimization (EXPERIMENTS.md #Perf GJ-1): single-variable
    # semijoin pre-reduction.  Every factor is filtered to the intersection
    # of each shared variable's value set across all factors before any
    # expansion -- a Yannakakis-style pass that removes most UIR up front
    # and shrinks both the pairwise products and the WCOJ frontier.
    if len(factors) >= 2:
        var_sets: dict = {}
        for f in factors:
            for v in f.vars:
                var_sets.setdefault(v, []).append(f)
        inter: dict = {}
        for v, fs in var_sets.items():
            if len(fs) < 2:
                continue
            cur = None
            for f in fs:
                vals = np.unique(f.col(v))
                cur = vals if cur is None else cur[
                    np.searchsorted(vals, cur) < len(vals)]
                if cur is not None and len(cur) and len(vals):
                    pos = np.clip(np.searchsorted(vals, cur), 0, len(vals) - 1)
                    cur = cur[vals[pos] == cur]
            inter[v] = cur
        reduced = []
        for f in factors:
            mask = np.ones(f.num_entries, bool)
            for v in f.vars:
                if v in inter:
                    vals = inter[v]
                    col = f.col(v)
                    if len(vals) == 0:
                        mask &= False
                        continue
                    pos = np.clip(np.searchsorted(vals, col), 0, len(vals) - 1)
                    mask &= vals[pos] == col
            if mask.all():
                reduced.append(f)
            else:
                reduced.append(Factor(f.vars, f.keys[mask], f.bucket[mask],
                                      f.fac[mask], f.sizes))
        factors = reduced

    # fast path: two factors -> plain sorted-merge product
    if len(factors) == 2:
        return factors[0].multiply(factors[1])

    # frontier WCOJ over distinct keys
    sizes_of = {}
    for f in factors:
        for v, s in zip(f.vars, f.sizes):
            sizes_of[v] = s
    frontier = Factor((), np.zeros((1, 0), INT), np.ones(1, INT), np.ones(1, INT), ())
    bound: List[str] = []
    for v in order:
        rel = [f for f in factors if v in f.vars]
        # expand through the SMALLEST projection and semijoin with the
        # rest: the frontier set is the same whichever relation expands
        # (intersection semantics), but expansion cost is the frontier x
        # per-key degree of the expander, so the fewest-distinct-rows
        # projection is the cheapest intersection anchor — this is the
        # "per-level intersection on the smallest potential" of generic
        # join, and it is what keeps skewed bag steps near the AGM bound
        # instead of near the hottest relation's degree.
        projs = [distinct_projection(
            f, [u for u in bound if u in f.vars] + [v]) for f in rel]
        if projs:
            k = min(range(len(projs)), key=lambda i: projs[i].num_entries)
            frontier = frontier.multiply(projs[k])
            for i, proj in enumerate(projs):
                if i != k:
                    frontier = frontier.semijoin(proj)
        bound.append(v)

    # Bucket_Product: fold every factor's values into the joint keys
    joint = frontier.project(tuple(order))
    bucket = np.ones(joint.num_entries, INT)
    fac = np.ones(joint.num_entries, INT)
    for f in factors:
        idx = _match_indices(joint, f)
        # every surviving prefix extends to full matches in every factor
        if joint.num_entries and (idx < 0).any():  # pragma: no cover - invariant
            raise AssertionError("WCOJ frontier produced a non-matching row")
        if joint.num_entries:
            bucket *= f.bucket[idx]
            fac *= f.fac[idx]
    return Factor(joint.vars, joint.keys, bucket, fac, joint.sizes)
