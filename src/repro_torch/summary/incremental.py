"""Incremental GFJS maintenance on base-table appends (DESIGN.md §12).

A summary built by the Graphical Join pipeline is a pure function of the
per-occurrence potentials, and the elimination trace recorded by
``build_generator(record_trace=True)`` pins exactly how those potentials
flowed through Algorithm 2: which table factors and which messages fed
each step.  On an append, therefore:

* only the appended block is encoded (the base rows are never rescanned);
* each touched occurrence's potential is upgraded with
  ``Factor.merge_counts`` (GROUP BY of the block, pointwise-added);
* only the *dirty* steps — those whose inputs are reachable from the
  appended table in the message-flow DAG — are re-run; every clean step's
  conditional factor and message are reused verbatim;
* the GFJS is re-emitted with a *splice*: for the prefix of levels whose
  psi structure did not change, the cached ``(src, cidx)`` gather indices
  replay the weight propagation (no group lookups, no expansion); the
  first structurally-changed level falls back to the generic frontier
  expansion from there down.

Appends may introduce values never seen before: dictionary codes are
assigned in sorted raw order, so a grown domain *shifts* codes.  The
refresher computes one monotone ``old code -> new code`` remap per grown
variable and rewrites every retained artifact (factors, messages, psis,
summary levels) through it — monotonicity preserves every sort and CSR
grouping, so remapping is a pure gather, never a re-sort.

Equivalence with a from-scratch rebuild under the same plan is the
contract (tests/test_incremental.py runs the differential harness);
``benchmarks/incremental_bench.py`` measures the refresh-vs-rebuild gap.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.elimination import (EliminationTrace, Generator, Psi,
                                    StepTrace, assemble_generator,
                                    eliminate_step, root_marginal)
from repro_torch.core.gfjs import GFJS, LevelSummary, expand_level, generate_gfjs
from repro_torch.core.potentials import INT, Factor
from repro_torch.relational.encoding import Domain
from repro_torch.relational.query import JoinQuery
from repro_torch.relational.table import Table, TableDelta


class DeltaError(ValueError):
    """The delta cannot be applied incrementally; rebuild instead."""


class StaleDeltaError(DeltaError):
    """Version chain mismatch: the state is not at the delta's base."""


ExpansionCache = List[List[Tuple[np.ndarray, np.ndarray]]]


@dataclass
class IncrementalState:
    """Everything needed to refresh one summary without a rebuild."""

    query: JoinQuery
    plan: object                          # PhysicalPlan (kept duck-typed)
    domains: Dict[str, Domain]
    table_versions: Dict[str, str]        # versions this state reflects
    generator: Generator                  # carries the EliminationTrace
    gfjs: GFJS
    expansion_cache: ExpansionCache
    cache_key: Optional[str] = None       # where the service cached gfjs
    last_report: Dict[str, float] = field(default_factory=dict)

    def nbytes(self) -> int:
        n = self.generator.nbytes() + self.gfjs.nbytes()
        if self.generator.trace is not None:
            n += self.generator.trace.nbytes()
        for level in self.expansion_cache:
            n += sum(int(s.nbytes + c.nbytes) for s, c in level)
        return int(n)


def capture_state(executor, gfjs: GFJS,
                  versions: Optional[Mapping[str, str]] = None
                  ) -> IncrementalState:
    """Snapshot a freshly-run pipeline into an :class:`IncrementalState`.

    ``executor`` is a ``repro_torch.plan.executor.Executor`` (or a
    ``GraphicalJoin``, which is unwrapped) that ran with
    ``record_trace=True``.  ``versions`` overrides the table versions read
    from the catalog — pass the versions the caller keyed its cache on so
    a concurrent append cannot skew the snapshot.
    """
    ex = getattr(executor, "_executor", executor)
    gen = ex.generator
    if gen is None or gen.trace is None:
        raise ValueError("capture_state needs a record_trace=True run")
    if ex.expansion_cache is None:
        raise ValueError("capture_state needs the summarize expansion cache")
    query = ex.query
    if versions is None:
        # prefer the versions build_model actually encoded: reading the
        # live catalog here could pick up an append the summary never saw
        versions = getattr(ex, "source_versions", None) or {
            qt.table: ex.catalog[qt.table].version() for qt in query.tables}
    return IncrementalState(
        query=query,
        plan=ex.plan,
        domains=dict(ex.enc.domains),
        table_versions=dict(versions),
        generator=gen,
        gfjs=gfjs,
        expansion_cache=ex.expansion_cache,
    )


# ---------------------------------------------------------------------------
# delta normalization
# ---------------------------------------------------------------------------

def _coalesce_deltas(state: IncrementalState, deltas: Sequence[TableDelta]
                     ) -> Tuple[Dict[str, Table], Dict[str, str]]:
    """Chain-validate and merge deltas into one block per table.

    Deltas for tables outside the query are ignored.  A broken version
    chain (the state is not at a delta's base, or deltas arrive out of
    order) raises :class:`StaleDeltaError` — the caller's cue to rebuild.
    """
    query_tables = {qt.table for qt in state.query.tables}
    per_table: Dict[str, List[TableDelta]] = {}
    for d in deltas:
        if d.table in query_tables:
            per_table.setdefault(d.table, []).append(d)
    blocks: Dict[str, Table] = {}
    new_versions = dict(state.table_versions)
    for t, ds in per_table.items():
        v = new_versions[t]
        for d in ds:
            if d.base_version != v:
                raise StaleDeltaError(
                    f"delta chain for {t!r} expects base {d.base_version[:8]}, "
                    f"state is at {v[:8]}")
            v = d.new_version
        new_versions[t] = v
        block = ds[0].block
        for d in ds[1:]:
            block = block.concat(d.block)
        blocks[t] = block
    return blocks, new_versions


# ---------------------------------------------------------------------------
# domain growth: monotone code remaps
# ---------------------------------------------------------------------------

def _grow_domains(state: IncrementalState, blocks: Mapping[str, Table]
                  ) -> Tuple[Dict[str, Domain], Dict[str, np.ndarray]]:
    """Extend domains with the blocks' unseen values; return code remaps.

    The remap for a grown variable maps every *old* code to its position
    in the grown (still sorted) domain — a monotone injection, so sorted
    structures stay sorted after the gather.
    """
    domains = dict(state.domains)
    remaps: Dict[str, np.ndarray] = {}
    fresh: Dict[str, List[np.ndarray]] = {}
    for qt in state.query.tables:
        blk = blocks.get(qt.table)
        if blk is None:
            continue
        for col, var in qt.var_map:
            fresh.setdefault(var, []).append(blk[col])
    for var, cols in fresh.items():
        old = domains[var]
        vals = np.unique(np.concatenate([np.unique(c) for c in cols]))
        if old.size and old.values.dtype.kind != vals.dtype.kind:
            raise DeltaError(
                f"append changes the dtype kind of variable {var!r} "
                f"({old.values.dtype} vs {vals.dtype})")
        merged = np.union1d(old.values, vals)
        if len(merged) != old.size:
            domains[var] = Domain(var, merged)
            remaps[var] = np.searchsorted(merged, old.values).astype(INT)
    return domains, remaps


def _remap_factor(f: Factor, remaps: Mapping[str, np.ndarray],
                  sizes: Mapping[str, int]) -> Factor:
    if not any(v in remaps for v in f.vars):
        return f
    keys = f.keys.copy()
    for j, v in enumerate(f.vars):
        if v in remaps:
            keys[:, j] = remaps[v][keys[:, j]]
    return Factor(f.vars, keys, f.bucket, f.fac,
                  tuple(int(sizes[v]) for v in f.vars))


def _remap_psi(p: Psi, remaps: Mapping[str, np.ndarray],
               sizes: Mapping[str, int]) -> Psi:
    if not any(v in remaps for v in p.parents) and p.child not in remaps:
        return p
    pk = p.parent_keys
    if any(v in remaps for v in p.parents):
        pk = pk.copy()
        for j, v in enumerate(p.parents):
            if v in remaps:
                pk[:, j] = remaps[v][pk[:, j]]
    cc = p.child_codes
    if p.child in remaps:
        cc = remaps[p.child][cc]
    return Psi(p.child, p.parents, pk, p.start, p.count, cc,
               p.bucket, p.fac,
               tuple(int(sizes[v]) for v in p.parents),
               int(sizes[p.child]))


def _remap_levels(gfjs: GFJS, remaps: Mapping[str, np.ndarray]
                  ) -> List[LevelSummary]:
    """The old summary's levels with grown-domain codes rewritten.

    Arrays untouched by any remap are shared, never copied — concurrent
    readers of the old GFJS are unaffected.
    """
    if not remaps:
        return list(gfjs.levels)
    out = []
    for lvl in gfjs.levels:
        cols = {v: (remaps[v][c] if v in remaps else c)
                for v, c in lvl.key_cols.items()}
        out.append(LevelSummary(lvl.vars, cols, lvl.freq))
    return out


# ---------------------------------------------------------------------------
# the refresh
# ---------------------------------------------------------------------------

def _psi_structure_equal(a: Optional[Psi], b: Optional[Psi]) -> bool:
    """Same CSR layout (groups, counts, child codes) — values may differ."""
    if a is None or b is None:
        return a is b
    return (a.parents == b.parents
            and a.parent_keys.shape == b.parent_keys.shape
            and np.array_equal(a.parent_keys, b.parent_keys)
            and np.array_equal(a.count, b.count)
            and np.array_equal(a.child_codes, b.child_codes))


def _frontier_cols(levels: Sequence[LevelSummary], upto: int
                   ) -> Dict[str, np.ndarray]:
    """Frontier columns (all vars of levels 0..upto) at level-``upto`` runs.

    Levels refine, so each deep run's start offset falls inside exactly one
    shallow run — the same ancestor search the summary algebra uses.
    """
    deep = levels[upto]
    starts_deep = np.cumsum(deep.freq) - deep.freq
    cols: Dict[str, np.ndarray] = {}
    for j in range(upto + 1):
        lvl = levels[j]
        if j == upto:
            anc = np.arange(lvl.num_runs, dtype=INT)
        else:
            anc = np.searchsorted(np.cumsum(lvl.freq), starts_deep,
                                  side="right").astype(INT)
        for v in lvl.vars:
            cols[v] = lvl.key_cols[v][anc]
    return cols


def refresh_state(state: IncrementalState, deltas: Sequence[TableDelta]
                  ) -> Tuple[IncrementalState, Dict[str, float]]:
    """Apply base-table appends to a summary; returns (new state, report).

    The input state is never mutated: clean artifacts are shared between
    old and new state (remapped copies when a domain grew), so concurrent
    readers of the old summary keep a consistent view.
    """
    trace = state.generator.trace
    if trace is None:
        raise ValueError("state has no elimination trace")
    t0 = time.perf_counter()

    blocks, new_versions = _coalesce_deltas(state, deltas)
    appended = sum(b.num_rows for b in blocks.values())

    domains, remaps = _grow_domains(state, blocks)
    sizes = {v: d.size for v, d in domains.items()}

    # 1. upgrade the touched occurrences' potentials from the blocks alone
    factors = [_remap_factor(f, remaps, sizes) for f in trace.factors]
    dirty_occ = set()
    for i, qt in enumerate(state.query.tables):
        blk = blocks.get(qt.table)
        if blk is None or blk.num_rows == 0:
            continue
        enc_cols = {var: domains[var].encode(blk[col])
                    for col, var in qt.var_map}
        factors[i] = factors[i].merge_counts(
            Factor.from_columns(enc_cols, sizes))
        dirty_occ.add(i)

    # 2. re-run only the dirty steps; reuse every clean psi and message
    order = list(state.generator.elimination_order)
    out_vars = state.query.output_variables
    dirty_vars: set = set()
    msg_of: Dict[str, Factor] = {}
    psis: Dict[str, Psi] = {}
    parents_of: Dict[str, Tuple[str, ...]] = {}
    structure_same: Dict[str, bool] = {}
    new_steps: List[StepTrace] = []
    for st in trace.steps:
        dirty = (any(i in dirty_occ for i in st.rel_tables)
                 or any(u in dirty_vars for u in st.rel_msgs))
        if not dirty:
            msg = _remap_factor(st.message, remaps, sizes)
            psi = (_remap_psi(st.psi, remaps, sizes)
                   if st.psi is not None else None)
            structure_same[st.var] = True
            new_steps.append(replace(st, message=msg, psi=psi))
        else:
            dirty_vars.add(st.var)
            rel = [factors[i] for i in st.rel_tables] \
                + [msg_of[u] for u in st.rel_msgs]
            psi, parents, msg = eliminate_step(rel, st.var, order, out_vars)
            if parents != st.parents:  # pragma: no cover - structural invariant
                raise AssertionError(
                    f"refresh changed separator of {st.var}: "
                    f"{st.parents} -> {parents}")
            old_psi = (_remap_psi(st.psi, remaps, sizes)
                       if st.psi is not None else None)
            structure_same[st.var] = _psi_structure_equal(old_psi, psi)
            new_steps.append(replace(st, message=msg, psi=psi))
        last = new_steps[-1]
        msg_of[st.var] = last.message
        parents_of[st.var] = last.parents
        if last.psi is not None:
            psis[st.var] = last.psi

    # 3. root marginal: always recomputed (1-D products; frequencies of the
    # whole tree flow into it, so any append moves it)
    leftover = [factors[i] for i in trace.root_tables] \
        + [msg_of[u] for u in trace.root_msgs]
    phi_root = root_marginal(leftover, order[-1])

    gen = assemble_generator(
        order, psis, parents_of, phi_root, stats=dict(state.generator.stats),
        trace=EliminationTrace(new_steps, trace.root_tables,
                               trace.root_msgs, factors))

    # 4. splice: replay weights over the structurally-unchanged prefix,
    # full expansion from the first changed level down
    old_levels = _remap_levels(state.gfjs, remaps)
    old_root = old_levels[0].key_cols[gen.root]
    root_same = np.array_equal(gen.root_codes, old_root)
    gfjs, cache, spliced = _regenerate(
        gen, domains, old_levels, state.expansion_cache,
        structure_same, root_same)

    report = {
        "rows_appended": float(appended),
        "tables_touched": float(len(blocks)),
        "dirty_steps": float(len(dirty_vars)),
        "total_steps": float(len(trace.steps)),
        "spliced_levels": float(spliced),
        "total_levels": float(len(gfjs.levels)),
        "grown_domains": float(len(remaps)),
        "seconds": time.perf_counter() - t0,
    }
    new_state = IncrementalState(
        query=state.query,
        plan=state.plan,
        domains=domains,
        table_versions=new_versions,
        generator=gen,
        gfjs=gfjs,
        expansion_cache=cache,
        last_report=report,
    )
    return new_state, report


def _regenerate(gen: Generator, domains: Dict[str, Domain],
                old_levels: List[LevelSummary], old_cache: ExpansionCache,
                structure_same: Mapping[str, bool], root_same: bool
                ) -> Tuple[GFJS, ExpansionCache, int]:
    """Emit the refreshed GFJS, splicing over the clean level prefix."""
    n_levels = len(gen.levels) + 1

    # longest prefix of levels whose run structure is provably unchanged
    clean = 0
    if root_same and len(old_levels) == n_levels \
            and len(old_cache) == len(gen.levels):
        clean = 1
        for li, level in enumerate(gen.levels):
            ok = (tuple(p.child for p in level) == old_levels[li + 1].vars
                  and len(old_cache[li]) == len(level)
                  and all(structure_same.get(p.child, False) for p in level))
            if not ok:
                break
            clean += 1

    if clean == 0:
        cache: ExpansionCache = []
        return generate_gfjs(gen, domains, cache), cache, 0

    # weight re-propagation down the unchanged chain: pure gathers
    levels_out: List[LevelSummary] = [
        LevelSummary((gen.root,), {gen.root: gen.root_codes}, gen.root_freq)]
    cache = []
    p_bucket = np.ones(len(gen.root_codes), INT)
    for li in range(clean - 1):
        level = gen.levels[li]
        fac_acc = None
        for psi, (src, cidx) in zip(level, old_cache[li]):
            p_bucket = p_bucket[src] * psi.bucket[cidx]
            # the first psi's fac starts the accumulator directly — a
            # gather of an all-ones array is pure memory traffic, and the
            # replay is gather-bound
            fac_acc = (psi.fac[cidx] if fac_acc is None
                       else fac_acc[src] * psi.fac[cidx])
        old = old_levels[li + 1]
        levels_out.append(LevelSummary(old.vars, dict(old.key_cols),
                                       p_bucket * fac_acc))
        cache.append(list(old_cache[li]))

    if clean < n_levels:
        # resume the generic expansion below the spliced prefix; the
        # frontier there is reconstructible because its structure matches
        # the old summary run-for-run
        cols = _frontier_cols(old_levels, clean - 1)
        for li in range(clean - 1, len(gen.levels)):
            cols, p_bucket, freq, new_vars, level_cache = expand_level(
                cols, p_bucket, gen.levels[li])
            levels_out.append(LevelSummary(
                new_vars, {v: cols[v] for v in new_vars}, freq))
            cache.append(level_cache)

    gfjs = GFJS(levels_out, list(gen.column_order), gen.join_size, domains)
    return gfjs, cache, clean
