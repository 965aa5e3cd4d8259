"""GFJS relational algebra — aggregates and filters in O(num_runs).

Every operator here reads the RLE runs of the summary, never the |Q| rows
they encode.  The enabling facts (paper Definition 1 + DESIGN.md §9):

* a level's run lengths sum to |Q|, so COUNT is one reduction;
* consecutive levels *refine* each other (every parent boundary appears
  among child boundaries), so any run maps to its enclosing run at a
  shallower level with one ``searchsorted`` of start offsets — that is how
  GROUP BY keys and filter masks travel between levels;
* dictionary codes are assigned in sorted raw order, so MIN/MAX over codes
  equal MIN/MAX over values.

A :class:`SummaryFrame` pairs an (immutable) GFJS with per-level *effective*
run weights.  ``filter`` zeroes the weights of runs whose codes fail a
predicate and re-propagates down the level chain: children of a zeroed run
die with it, and every shallower level's weights are recomputed as the
segment-sum of its surviving deepest-level weights — so all levels keep
counting the same filtered multiset.  Weighted reductions route through
``repro_torch.core.engine.segment_weighted_sum`` (the CUDA ``mul_segsum``
kernel on the frame's device), which is the hot loop of the whole
subsystem; large GROUP BYs sort on the device through
``engine.group_runs_device``.  A frame carries the device its reductions
run on (``SummaryFrame.of(gfjs, device="cuda")``; ``"cpu"`` runs the
kernels' plain PyTorch versions), and ``filter`` passes it on.

Port of ``src/repro/summary/algebra.py``: only the engine call sites and
the frame's ``device`` differ from the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.core import engine
from repro_torch.core.gfjs import GFJS
from repro_torch.core.potentials import INT, _rank_rows, group_ranks

Predicate = Union[Callable[[np.ndarray], np.ndarray], int, float, str,
                  Sequence, set, frozenset]

# (op, variable) pairs; "count" needs no variable
AggSpec = Union[str, Tuple[str, str]]

_NUMERIC_KINDS = ("i", "u", "f")


def _run_values(gfjs: GFJS, var: str, codes: np.ndarray) -> np.ndarray:
    vals = gfjs.domains[var].decode(codes)
    if vals.dtype.kind not in _NUMERIC_KINDS:
        raise TypeError(f"variable {var!r} has non-numeric domain "
                        f"({vals.dtype}); only count/distinct apply")
    return vals


def _eval_predicate(pred: Predicate, values: np.ndarray) -> np.ndarray:
    if callable(pred):
        mask = np.asarray(pred(values), dtype=bool)
        if mask.shape != values.shape:
            raise ValueError("predicate must return one bool per run value")
        return mask
    if isinstance(pred, (list, tuple, set, frozenset)):
        return np.isin(values, np.asarray(sorted(pred)))
    return values == pred


@dataclass
class SummaryFrame:
    """A GFJS plus per-level effective run weights (filters applied)."""

    gfjs: GFJS
    weights: List[np.ndarray]  # one int64 array per level, same runs as gfjs
    device: torch.device = torch.device("cuda")  # where reductions run

    # -- constructors ------------------------------------------------------
    @staticmethod
    def of(gfjs, device: Union[str, torch.device] = "cuda"
           ) -> "SummaryFrame":
        """Frame over a summary; a ShardedGFJS gets the shard-merging twin.

        Dispatching here keeps every caller (``GraphicalJoin.aggregate``)
        oblivious to sharding.  ``device="cuda"`` without a card raises.
        """
        from repro_torch.core.gfjs import ShardedGFJS
        dev = engine.resolve_device(device)
        if isinstance(gfjs, ShardedGFJS):
            return ShardedSummaryFrame.of(gfjs, dev)
        return SummaryFrame(
            gfjs, [lvl.freq.astype(INT) for lvl in gfjs.levels], dev)

    # -- structure helpers -------------------------------------------------
    def level_of(self, var: str) -> int:
        for i, lvl in enumerate(self.gfjs.levels):
            if var in lvl.vars:
                return i
        raise KeyError(f"variable {var!r} is not in the summary "
                       f"(columns: {self.gfjs.column_order})")

    def _starts(self, level: int) -> np.ndarray:
        """Exclusive row-offset starts of a level's runs."""
        lvl = self.gfjs.levels[level]
        return self.gfjs.bounds(level) - lvl.freq

    def _ancestors(self, deep: int, shallow: int) -> np.ndarray:
        """Enclosing run index at ``shallow`` for every run of ``deep``.

        Levels refine, so each deep run's start offset falls inside exactly
        one shallow run: one binary search over the cached prefix bounds.
        """
        if deep == shallow:
            return np.arange(self.gfjs.levels[deep].num_runs, dtype=INT)
        return np.searchsorted(self.gfjs.bounds(shallow),
                               self._starts(deep), side="right").astype(INT)

    @property
    def _deepest(self) -> int:
        return len(self.gfjs.levels) - 1

    def _codes_at(self, var: str, level: int) -> np.ndarray:
        """``var``'s code per run of ``level`` (>= var's own level)."""
        own = self.level_of(var)
        codes = self.gfjs.levels[own].key_cols[var]
        if own == level:
            return codes
        return codes[self._ancestors(level, own)]

    def _abs_value_bound(self, var: str) -> Optional[float]:
        """O(1) upper bound on |raw value| of ``var``.

        Dictionary values are stored sorted, so the extremes are the
        endpoints — no scan.  None for empty or non-numeric domains.
        """
        vals = self.gfjs.domains[var].values
        if len(vals) == 0 or vals.dtype.kind not in _NUMERIC_KINDS:
            return None
        return float(max(abs(float(vals[0])), abs(float(vals[-1]))))

    # -- filtering ---------------------------------------------------------
    def filter(self, preds: Optional[Mapping[str, Predicate]] = None,
               **kw: Predicate) -> "SummaryFrame":
        """Predicate pushdown: zero failing runs, re-propagate weights.

        ``preds`` maps variable -> predicate (a callable over the run's raw
        values, a scalar for equality, or a list/set for membership).  Cost
        is O(runs log runs); the result is a new frame over the same GFJS.
        """
        merged: Dict[str, Predicate] = dict(preds or {})
        merged.update(kw)
        if not merged:
            return self
        deep = self._deepest
        nd = self.gfjs.levels[deep].num_runs
        keep = np.ones(nd, dtype=bool)
        for var, pred in merged.items():
            own = self.level_of(var)
            codes = self.gfjs.levels[own].key_cols[var]
            mask = _eval_predicate(pred, self.gfjs.domains[var].decode(codes))
            keep &= mask if own == deep else mask[self._ancestors(deep, own)]
        deep_w = np.where(keep, self.weights[deep], 0).astype(INT)
        return self._with_deep_weights(deep_w)

    def _with_deep_weights(self, deep_w: np.ndarray) -> "SummaryFrame":
        """Rebuild every level's weights from new deepest-level weights."""
        deep = self._deepest
        ones = np.ones(len(deep_w), INT)
        new: List[np.ndarray] = [None] * (deep + 1)  # type: ignore[list-item]
        new[deep] = deep_w
        # deep_w only zeroes existing weights, so this frame's (cached)
        # count bounds every propagated segment sum — the O(1) kernel guard
        bound = float(self.count())
        for j in range(deep):
            anc = self._ancestors(deep, j)
            # anc is sorted ascending and dense over 0..runs_j-1
            new[j] = engine.segment_weighted_sum(
                anc.astype(np.int32), deep_w, ones,
                self.gfjs.levels[j].num_runs, device=self.device,
                bound=bound)
        return SummaryFrame(self.gfjs, new, self.device)

    # -- scalar aggregates -------------------------------------------------
    def count(self) -> int:
        """|Q| under the current filters — one O(runs) reduction.

        Filter propagation keeps every level summing to the same filtered
        total, so the root level (fewest runs) is the cheapest to read.
        Cached per frame: it doubles as the O(1) exactness bound for every
        weighted reduction (each level sums to the same filtered count).
        """
        c = getattr(self, "_count", None)
        if c is None:
            c = int(self.weights[0].sum()) if self.gfjs.levels else 0
            self._count = c
        return c

    def sum(self, var: str):
        """SUM(var) over the (filtered) join multiset."""
        lv = self.level_of(var)
        vals = _run_values(self.gfjs, var, self.gfjs.levels[lv].key_cols[var])
        vb = self._abs_value_bound(var)
        bound = None if vb is None else vb * self.count()
        out = engine.weighted_total(vals, self.weights[lv],
                                    device=self.device, bound=bound)
        return float(out) if vals.dtype.kind == "f" else int(out)

    def mean(self, var: str) -> Optional[float]:
        c = self.count()
        return None if c == 0 else self.sum(var) / c

    def min(self, var: str):
        return self._extreme(var, np.min)

    def max(self, var: str):
        return self._extreme(var, np.max)

    def _extreme(self, var: str, reduce_fn):
        lv = self.level_of(var)
        codes = self.gfjs.levels[lv].key_cols[var]
        live = self.weights[lv] > 0
        if not live.any():
            return None
        # codes order == raw-value order (dictionary encode is sorted)
        code = reduce_fn(codes[live])
        return self.gfjs.domains[var].decode(np.asarray([code]))[0]

    def distinct(self, var: str) -> np.ndarray:
        """Sorted distinct raw values of ``var`` with surviving weight."""
        lv = self.level_of(var)
        codes = self.gfjs.levels[lv].key_cols[var]
        live = np.unique(codes[self.weights[lv] > 0])
        return self.gfjs.domains[var].decode(live)

    def count_distinct(self, var: str) -> int:
        lv = self.level_of(var)
        codes = self.gfjs.levels[lv].key_cols[var]
        return int(len(np.unique(codes[self.weights[lv] > 0])))

    # -- grouped aggregates ------------------------------------------------
    def group_by(self, keys: Union[str, Sequence[str]],
                 **aggs: AggSpec) -> Dict[str, np.ndarray]:
        """GROUP BY ``keys`` with named aggregates, all in O(runs log runs).

            frame.group_by("A", n="count", total=("sum", "D"))
            frame.group_by(["A", "B"], lo=("min", "D"), avg=("mean", "D"))

        Returns a dict of aligned arrays: one decoded column per key plus
        one per aggregate, rows sorted by key values.  Supported ops:
        count, sum, mean, min, max.
        """
        dev = self.device

        def segment_weighted_sum(*args, **kw):
            return engine.segment_weighted_sum(*args, device=dev, **kw)

        if isinstance(keys, str):
            keys = [keys]
        if not keys:
            raise ValueError("group_by needs at least one key variable")
        if not aggs:
            aggs = {"count": "count"}
        specs: Dict[str, Tuple[str, Optional[str]]] = {}
        for name, spec in aggs.items():
            if spec == "count":
                specs[name] = ("count", None)
            else:
                op, var = spec  # type: ignore[misc]
                if op not in ("sum", "mean", "min", "max", "count"):
                    raise ValueError(f"unknown aggregate op {op!r}")
                specs[name] = (op, var)

        involved = list(keys) + [v for _, v in specs.values() if v is not None]
        work = max(self.level_of(v) for v in involved)
        w = self.weights[work]
        live = w > 0

        key_codes = np.stack(
            [self._codes_at(k, work)[live] for k in keys], axis=1)
        w = w[live].astype(INT)
        nlive = key_codes.shape[0]
        empty: Dict[str, np.ndarray] = {}
        if nlive == 0:
            for k in keys:
                empty[k] = self.gfjs.domains[k].decode(np.zeros(0, INT))
            for name, (op, var) in specs.items():
                # dtype-match the non-empty result so callers can concatenate
                if op == "count":
                    empty[name] = np.zeros(0, INT)
                elif op == "mean":
                    empty[name] = np.zeros(0, np.float64)
                else:
                    assert var is not None
                    empty[name] = np.zeros(
                        0, self.gfjs.domains[var].values.dtype)
            return empty

        sizes = [self.gfjs.domains[k].size for k in keys]
        ranks, packed = _rank_rows(key_codes, sizes)
        if packed and nlive >= engine.GROUP_DEVICE_MIN_RUNS \
                and engine.group_device_enabled(dev):
            # large run counts: packed-key sort and run boundaries on the
            # card (DESIGN.md §14)
            order, seg, starts, ngroups = engine.group_runs_device(
                ranks, device=dev)
        else:
            order, seg, starts, ngroups = group_ranks(ranks)
        w_s = w[order]
        sorted_codes = key_codes[order]

        out: Dict[str, np.ndarray] = {}
        for j, k in enumerate(keys):
            out[k] = self.gfjs.domains[k].decode(sorted_codes[starts, j])

        counts: Optional[np.ndarray] = None

        total_w = float(self.count())   # O(1)-guard bound: sum w_s <= count

        def group_counts() -> np.ndarray:
            nonlocal counts
            if counts is None:
                counts = segment_weighted_sum(
                    seg, np.ones(nlive, INT), w_s, ngroups, bound=total_w)
            return counts

        for name, (op, var) in specs.items():
            if op == "count":
                out[name] = group_counts().copy()
                continue
            assert var is not None
            vals = _run_values(self.gfjs, var,
                               self._codes_at(var, work)[live])[order]
            if op in ("sum", "mean"):
                vb = self._abs_value_bound(var)
                sums = segment_weighted_sum(
                    seg, vals, w_s, ngroups,
                    bound=None if vb is None else vb * total_w)
                if op == "sum":
                    out[name] = sums
                else:
                    out[name] = sums / group_counts()
            else:  # min / max — ufunc scatter over runs, O(runs)
                if op == "min":
                    acc = np.full(ngroups, np.inf)
                    np.minimum.at(acc, seg, vals)
                else:
                    acc = np.full(ngroups, -np.inf)
                    np.maximum.at(acc, seg, vals)
                if vals.dtype.kind in ("i", "u"):
                    acc = acc.astype(vals.dtype)
                out[name] = acc
        return out

    # -- interop -----------------------------------------------------------
    def to_gfjs(self) -> GFJS:
        """Materialize the filtered frame as a standalone GFJS.

        Zero-weight runs are dropped; run boundaries are rebuilt from the
        surviving weights.  The result desummarizes to exactly the filtered
        join result (used by tests to cross-check filters row-by-row).
        """
        from repro_torch.core.gfjs import LevelSummary
        levels = []
        for lvl, w in zip(self.gfjs.levels, self.weights):
            live = w > 0
            levels.append(LevelSummary(
                lvl.vars,
                {v: lvl.key_cols[v][live] for v in lvl.vars},
                w[live].astype(INT)))
        return GFJS(levels, list(self.gfjs.column_order), self.count(),
                    self.gfjs.domains)


# internal per-shard column names for the group_by merge; NUL bytes cannot
# collide with user aggregate names (they pass through **kwargs unharmed)
_MERGE_SUM = "\x00sum:"
_MERGE_CNT = "\x00cnt"


@dataclass
class ShardedSummaryFrame:
    """Shard-aware twin of :class:`SummaryFrame` over a ``ShardedGFJS``.

    Holds one :class:`SummaryFrame` per hash shard and merges at the
    *aggregate* level — never by concatenating summaries:

    * ``count`` / ``sum`` / ``mean`` distribute (sums of shard partials;
      mean is merged-sum over merged-count);
    * ``min`` / ``max`` / ``distinct`` reduce over shard results;
    * ``filter`` pushes the predicate into every shard frame;
    * ``group_by`` computes per-shard grouped partials (means decomposed
      into sum + count) and merges groups by key — shard results are
      key-sorted, and the merge re-sorts on dictionary codes, so the
      output ordering matches the monolithic frame exactly.

    Integer aggregates merge to *exactly* the monolithic numbers; float
    SUM/MEAN may differ in the last ulp (shard partial sums reassociate
    the additions).
    """

    sharded: "object"               # repro_torch.core.gfjs.ShardedGFJS
    frames: List[SummaryFrame]
    device: torch.device = torch.device("cuda")  # where reductions run

    @staticmethod
    def of(sharded, device: Union[str, torch.device] = "cuda"
           ) -> "ShardedSummaryFrame":
        dev = engine.resolve_device(device)
        return ShardedSummaryFrame(
            sharded, [SummaryFrame.of(s, dev) for s in sharded.shards], dev)

    # the summary backing this frame, under the same attribute name
    # SummaryFrame uses (provenance-reading callers stay oblivious)
    @property
    def gfjs(self):
        return self.sharded

    def level_of(self, var: str) -> int:
        return self.frames[0].level_of(var)   # identical structure per shard

    # -- filtering ---------------------------------------------------------
    def filter(self, preds: Optional[Mapping[str, Predicate]] = None,
               **kw: Predicate) -> "ShardedSummaryFrame":
        return ShardedSummaryFrame(
            self.sharded, [f.filter(preds, **kw) for f in self.frames],
            self.device)

    # -- scalar aggregates -------------------------------------------------
    def count(self) -> int:
        c = getattr(self, "_count", None)
        if c is None:
            c = int(sum(f.count() for f in self.frames))
            self._count = c
        return c

    def sum(self, var: str):
        return sum(f.sum(var) for f in self.frames)

    def mean(self, var: str) -> Optional[float]:
        c = self.count()
        return None if c == 0 else self.sum(var) / c

    def min(self, var: str):
        vals = [v for v in (f.min(var) for f in self.frames) if v is not None]
        return min(vals) if vals else None

    def max(self, var: str):
        vals = [v for v in (f.max(var) for f in self.frames) if v is not None]
        return max(vals) if vals else None

    def distinct(self, var: str) -> np.ndarray:
        return np.unique(np.concatenate(
            [f.distinct(var) for f in self.frames]))

    def count_distinct(self, var: str) -> int:
        return int(len(self.distinct(var)))

    # -- grouped aggregates ------------------------------------------------
    def group_by(self, keys: Union[str, Sequence[str]],
                 **aggs: AggSpec) -> Dict[str, np.ndarray]:
        """GROUP BY with shard merge; same contract as the monolithic frame."""
        if isinstance(keys, str):
            keys = [keys]
        if not keys:
            raise ValueError("group_by needs at least one key variable")
        if not aggs:
            aggs = {"count": "count"}
        specs: Dict[str, Tuple[str, Optional[str]]] = {}
        for name, spec in aggs.items():
            if spec == "count":
                specs[name] = ("count", None)
            else:
                op, var = spec  # type: ignore[misc]
                if op not in ("sum", "mean", "min", "max", "count"):
                    raise ValueError(f"unknown aggregate op {op!r}")
                specs[name] = (op, var)

        # shard-level request: a mean cannot be merged, its sum and count
        # can — decompose, merge, divide
        shard_aggs: Dict[str, AggSpec] = {}
        need_cnt = any(op == "mean" for op, _ in specs.values())
        for name, (op, var) in specs.items():
            if op == "mean":
                shard_aggs[_MERGE_SUM + name] = ("sum", var)
            else:
                shard_aggs[name] = (op, var)
        if need_cnt:
            shard_aggs[_MERGE_CNT] = "count"
        tabs = [f.group_by(list(keys), **shard_aggs) for f in self.frames]

        def col(name: str) -> np.ndarray:
            return np.concatenate([t[name] for t in tabs])

        key_vals = {k: col(k) for k in keys}
        n = len(key_vals[keys[0]])
        out: Dict[str, np.ndarray] = {}
        if n == 0:
            out.update(key_vals)
            for name, (op, _) in specs.items():
                out[name] = (np.zeros(0, np.float64) if op == "mean"
                             else col(name))
            return out

        # group on re-encoded dictionary codes: code order == raw-value
        # order, so the merged ordering equals the monolithic frame's
        doms = self.sharded.domains
        codes = np.stack([doms[k].encode(key_vals[k]) for k in keys], axis=1)
        sizes = [doms[k].size for k in keys]
        ranks, _ = _rank_rows(codes, sizes)
        order, seg, starts, ngroups = group_ranks(ranks)
        for k in keys:
            out[k] = key_vals[k][order][starts]

        cnt: Optional[np.ndarray] = None
        if need_cnt:
            c = col(_MERGE_CNT)[order]
            cnt = np.zeros(ngroups, c.dtype)
            np.add.at(cnt, seg, c)
        for name, (op, _) in specs.items():
            if op == "mean":
                s = col(_MERGE_SUM + name)[order]
                acc = np.zeros(ngroups, s.dtype)
                np.add.at(acc, seg, s)
                out[name] = acc / cnt
            elif op in ("count", "sum"):
                c = col(name)[order]
                acc = np.zeros(ngroups, c.dtype)
                np.add.at(acc, seg, c)
                out[name] = acc
            else:  # min / max: reduce from a representative per group
                c = col(name)[order]
                acc = c[starts].copy()
                (np.minimum if op == "min" else np.maximum).at(acc, seg, c)
                out[name] = acc
        return out

    # -- interop -----------------------------------------------------------
    def to_gfjs(self):
        """Materialize the filtered frame as a standalone ShardedGFJS."""
        from repro_torch.core.gfjs import ShardedGFJS
        shards = [f.to_gfjs() for f in self.frames]
        return ShardedGFJS(shards, list(self.sharded.column_order),
                           self.count(), self.sharded.domains,
                           self.sharded.partition_var, self.sharded.salt)
