"""Potentials (factors) over dictionary-encoded attribute domains.

A :class:`Factor` is the paper's *potential function*: an exact frequency
table over a set of query variables.  The paper implements potentials as
nested hash maps; per DESIGN.md §2 we use the TPU-idiomatic equivalent — a
COO tensor (lexsorted integer key rows + value columns) manipulated with
sort / searchsorted / segment-sum primitives.

Every factor carries **two** value columns:

* ``bucket`` — the product of *original* (table-derived) potential values
  folded into this factor so far;
* ``fac``    — the product of *message* values (sums produced by variable
  elimination) folded in so far.

The paper's Algorithm 2 stores exactly this split in its conditional factors
(columns named ``bucket`` and ``fac`` in Figure 8); keeping the split all the
way through the factor algebra is what lets GFJS generation run without any
divisions (see repro/core/elimination.py).
The effective frequency of an entry is always ``bucket * fac``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

INT = np.int64


def pack_keys(keys: np.ndarray, sizes: Sequence[int]) -> np.ndarray:
    """Mixed-radix pack of key columns into a single int64 rank.

    ``keys`` is [n, k]; ``sizes`` the per-column domain sizes.  Requires
    prod(sizes) < 2**63 (checked); callers fall back to lexsort otherwise.
    """
    total = 1
    for s in sizes:
        total *= max(int(s), 1)
        if total >= (1 << 62):
            raise OverflowError("key space too large to pack")
    if keys.ndim != 2:
        raise ValueError("keys must be [n, k]")
    out = np.zeros(len(keys), dtype=INT)
    for j, s in enumerate(sizes):
        out = out * max(int(s), 1) + keys[:, j]
    return out


def _rank_rows(keys: np.ndarray, sizes: Sequence[int]) -> Tuple[np.ndarray, bool]:
    """Return a 1-D sortable rank per row; bool says whether it's a pack
    (order-preserving & collision-free) or a dense re-rank."""
    try:
        return pack_keys(keys, sizes), True
    except OverflowError:
        # dense re-rank: lexsort, then run-index the unique rows
        order = np.lexsort(keys.T[::-1])
        sk = keys[order]
        new = np.ones(len(sk), dtype=bool)
        new[1:] = np.any(sk[1:] != sk[:-1], axis=1)
        run = np.cumsum(new) - 1
        ranks = np.empty(len(sk), dtype=INT)
        ranks[order] = run
        return ranks, False


def group_ranks(
    ranks: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Stable sort-and-segment of a 1-D rank array.

    Returns ``(order, seg, starts, num_groups)``: ``order`` sorts the
    ranks stably, ``seg[i]`` is the dense group id of sorted position
    ``i`` (int32 — group counts are bounded by the row count), ``starts``
    the sorted positions where a new group begins.  The host-side twin of
    ``engine_jax.group_runs_device`` and the one GROUP BY segmentation
    idiom shared by the summary algebra (monolithic and shard-merge).
    """
    order = np.argsort(ranks, kind="stable")
    sranks = ranks[order]
    new = np.ones(len(sranks), dtype=bool)
    new[1:] = sranks[1:] != sranks[:-1]
    seg = (np.cumsum(new) - 1).astype(np.int32)
    starts = np.flatnonzero(new)
    return order, seg, starts, len(starts)


@dataclass
class Factor:
    """COO frequency tensor over ``vars`` with bucket/fac value split."""

    vars: Tuple[str, ...]
    keys: np.ndarray     # [n, k] int64 codes, one column per var
    bucket: np.ndarray   # [n] int64
    fac: np.ndarray      # [n] int64
    sizes: Tuple[int, ...]  # per-var domain sizes (for packing)

    def __post_init__(self) -> None:
        self.keys = np.asarray(self.keys, dtype=INT).reshape(len(self.bucket), len(self.vars))
        self.bucket = np.asarray(self.bucket, dtype=INT)
        self.fac = np.asarray(self.fac, dtype=INT)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_columns(
        cols: Dict[str, np.ndarray], sizes: Dict[str, int]
    ) -> "Factor":
        """GROUP BY all columns, COUNT(*): the paper's quantitative learning.

        One scan (a lexsort + run-length count) per table: O(n log n) work,
        O(N) memory — the paper's 'scan each table once' step.
        """
        names = tuple(cols.keys())
        keys = np.stack([np.asarray(cols[v], dtype=INT) for v in names], axis=1)
        sz = tuple(int(sizes[v]) for v in names)
        if keys.shape[0] == 0:
            return Factor(names, keys, np.zeros(0, INT), np.zeros(0, INT), sz)
        ranks, _ = _rank_rows(keys, sz)
        order = np.argsort(ranks, kind="stable")
        keys = keys[order]
        sranks = ranks[order]
        new = np.ones(len(sranks), dtype=bool)
        new[1:] = sranks[1:] != sranks[:-1]
        starts = np.flatnonzero(new)
        counts = np.diff(np.append(starts, len(sranks)))
        ukeys = keys[starts]
        return Factor(names, ukeys, counts.astype(INT), np.ones(len(starts), INT), sz)

    @staticmethod
    def message(vars: Tuple[str, ...], keys: np.ndarray, value: np.ndarray,
                sizes: Tuple[int, ...]) -> "Factor":
        """A message factor: its value rides in the ``fac`` column."""
        return Factor(vars, keys, np.ones(len(value), INT), np.asarray(value, INT), sizes)

    def merge_counts(self, other: "Factor") -> "Factor":
        """Pointwise sum of two bucket-count factors over the same schema.

        The delta-refresh primitive: a base-table append's potential is the
        GROUP BY of the appended block alone, and the grown table's
        potential is ``old.merge_counts(delta)`` — O((n+d) log(n+d)) on
        factor entries, never a rescan of the base rows.  Both sides must
        be pure table potentials (``fac == 1`` everywhere).
        """
        if self.vars != other.vars or self.sizes != other.sizes:
            raise ValueError(
                f"merge_counts schema mismatch: {self.vars}/{self.sizes} "
                f"vs {other.vars}/{other.sizes}")
        if np.any(self.fac != 1) or np.any(other.fac != 1):
            raise ValueError("merge_counts only applies to table potentials")
        if other.num_entries == 0:
            return self
        if self.num_entries == 0:
            return other
        keys = np.concatenate([self.keys, other.keys], axis=0)
        bucket = np.concatenate([self.bucket, other.bucket])
        ranks, _ = _rank_rows(keys, self.sizes)
        order = np.argsort(ranks, kind="stable")
        keys, sranks, bucket = keys[order], ranks[order], bucket[order]
        new = np.ones(len(sranks), dtype=bool)
        new[1:] = sranks[1:] != sranks[:-1]
        starts = np.flatnonzero(new)
        seg = np.cumsum(new) - 1
        sums = np.zeros(len(starts), dtype=INT)
        np.add.at(sums, seg, bucket)
        return Factor(self.vars, keys[starts], sums,
                      np.ones(len(starts), INT), self.sizes)

    # -- basics --------------------------------------------------------------
    @property
    def num_entries(self) -> int:
        return len(self.bucket)

    @property
    def freq(self) -> np.ndarray:
        return self.bucket * self.fac

    def var_index(self, v: str) -> int:
        return self.vars.index(v)

    def col(self, v: str) -> np.ndarray:
        return self.keys[:, self.var_index(v)]

    def sort_by(self, by: Sequence[str]) -> "Factor":
        idx = [self.var_index(v) for v in by]
        sub = self.keys[:, idx]
        ranks, packed = _rank_rows(sub, [self.sizes[i] for i in idx])
        order = np.argsort(ranks, kind="stable")
        return Factor(self.vars, self.keys[order], self.bucket[order],
                      self.fac[order], self.sizes)

    def select_nonzero(self) -> "Factor":
        m = (self.bucket != 0) & (self.fac != 0)
        if m.all():
            return self
        return Factor(self.vars, self.keys[m], self.bucket[m], self.fac[m], self.sizes)

    # -- elimination primitives ---------------------------------------------
    def marginalize_out(self, v: str) -> "Factor":
        """Sum out ``v``: the sum half of the paper's sum-product operation.

        Result is a *message*: value = sum(bucket*fac) goes to ``fac``.
        """
        keep = [i for i, u in enumerate(self.vars) if u != v]
        kvars = tuple(self.vars[i] for i in keep)
        ksizes = tuple(self.sizes[i] for i in keep)
        if not keep:
            total = np.array([np.sum(self.bucket * self.fac)], dtype=INT)
            return Factor.message((), np.zeros((1, 0), INT), total, ())
        sub = self.keys[:, keep]
        ranks, _ = _rank_rows(sub, ksizes)
        order = np.argsort(ranks, kind="stable")
        sub, ranks = sub[order], ranks[order]
        val = (self.bucket * self.fac)[order]
        new = np.ones(len(ranks), dtype=bool)
        new[1:] = ranks[1:] != ranks[:-1]
        starts = np.flatnonzero(new)
        seg = np.cumsum(new) - 1
        sums = np.zeros(len(starts), dtype=INT)
        np.add.at(sums, seg, val)
        return Factor.message(kvars, sub[starts], sums, ksizes)

    def multiply(self, other: "Factor") -> "Factor":
        """Pairwise factor product (natural join of frequency tables).

        Buckets multiply with buckets, facs with facs — preserving the
        original/message provenance split through arbitrary products.
        """
        shared = [v for v in self.vars if v in other.vars]
        only_o = [v for v in other.vars if v not in self.vars]
        out_vars = self.vars + tuple(only_o)
        out_sizes = self.sizes + tuple(other.sizes[other.var_index(v)] for v in only_o)

        if not shared:  # Cartesian product (disconnected factors)
            n, m = self.num_entries, other.num_entries
            li = np.repeat(np.arange(n), m)
            ri = np.tile(np.arange(m), n)
            keys = np.concatenate(
                [self.keys[li]] +
                ([other.keys[ri][:, [other.var_index(v) for v in only_o]]] if only_o else []),
                axis=1)
            return Factor(out_vars, keys,
                          self.bucket[li] * other.bucket[ri],
                          self.fac[li] * other.fac[ri], out_sizes)

        si = [self.var_index(v) for v in shared]
        oi = [other.var_index(v) for v in shared]
        ssz = [self.sizes[i] for i in si]

        lrank, _ = _rank_rows_joint(self.keys[:, si], other.keys[:, oi], ssz)
        lr, rr = lrank
        lorder = np.argsort(lr, kind="stable")
        rorder = np.argsort(rr, kind="stable")
        lr_s, rr_s = lr[lorder], rr[rorder]

        # group boundaries on both sides
        lu, lstart = _runs(lr_s)
        ru, rstart = _runs(rr_s)
        lcount = np.diff(np.append(lstart, len(lr_s)))
        rcount = np.diff(np.append(rstart, len(rr_s)))

        # intersect group keys (both sides sorted unique: merge via
        # searchsorted -- profiling showed np.intersect1d's hash path
        # dominating cyclic-query elimination; see EXPERIMENTS.md #Perf)
        pos = np.searchsorted(ru, lu)
        pos_c = np.minimum(pos, max(len(ru) - 1, 0))
        match = (ru[pos_c] == lu) if len(ru) else np.zeros(len(lu), bool)
        li_g = np.flatnonzero(match)
        ri_g = pos[li_g]
        a = lcount[li_g]
        b = rcount[ri_g]
        group_out = a * b
        total = int(group_out.sum())
        # O(total) expansion via repeat (was searchsorted: EXPERIMENTS GJ-2)
        g = np.repeat(np.arange(len(group_out), dtype=INT), group_out)
        offsets = np.cumsum(group_out) - group_out
        local = np.arange(total, dtype=INT) - offsets[g]
        lrow = lorder[lstart[li_g][g] + local // b[g]]
        rrow = rorder[rstart[ri_g][g] + local % b[g]]

        cols = [self.keys[lrow]]
        if only_o:
            cols.append(other.keys[rrow][:, [other.var_index(v) for v in only_o]])
        keys = np.concatenate(cols, axis=1)
        return Factor(out_vars, keys,
                      self.bucket[lrow] * other.bucket[rrow],
                      self.fac[lrow] * other.fac[rrow], out_sizes)

    def semijoin(self, other: "Factor") -> "Factor":
        """Keep only entries whose shared-variable values appear in other."""
        shared = [v for v in self.vars if v in other.vars]
        if not shared:
            return self
        si = [self.var_index(v) for v in shared]
        oi = [other.var_index(v) for v in shared]
        ssz = [self.sizes[i] for i in si]
        (lr, rr), _ = _rank_rows_joint(self.keys[:, si], other.keys[:, oi], ssz)
        rs = np.sort(rr)
        pos = np.searchsorted(rs, lr)
        pos = np.minimum(pos, max(len(rs) - 1, 0))
        mask = (rs[pos] == lr) if len(rs) else np.zeros(len(lr), bool)
        return Factor(self.vars, self.keys[mask], self.bucket[mask],
                      self.fac[mask], self.sizes)

    def project(self, vars: Sequence[str]) -> "Factor":
        """Reorder/restrict columns (no aggregation)."""
        idx = [self.var_index(v) for v in vars]
        return Factor(tuple(vars), self.keys[:, idx], self.bucket, self.fac,
                      tuple(self.sizes[i] for i in idx))

    def total(self) -> int:
        return int(np.sum(self.bucket * self.fac))


def _runs(sorted_ranks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique values and run starts of a sorted 1-D array."""
    if len(sorted_ranks) == 0:
        return sorted_ranks, np.zeros(0, dtype=INT)
    new = np.ones(len(sorted_ranks), dtype=bool)
    new[1:] = sorted_ranks[1:] != sorted_ranks[:-1]
    starts = np.flatnonzero(new)
    return sorted_ranks[starts], starts


def _rank_rows_joint(
    a: np.ndarray, b: np.ndarray, sizes: Sequence[int]
) -> Tuple[Tuple[np.ndarray, np.ndarray], bool]:
    """Consistent 1-D ranks for two key matrices over the same columns."""
    try:
        return (pack_keys(a, sizes), pack_keys(b, sizes)), True
    except OverflowError:
        both = np.concatenate([a, b], axis=0)
        order = np.lexsort(both.T[::-1])
        sk = both[order]
        new = np.ones(len(sk), dtype=bool)
        new[1:] = np.any(sk[1:] != sk[:-1], axis=1)
        run = np.cumsum(new) - 1
        ranks = np.empty(len(sk), dtype=INT)
        ranks[order] = run
        return (ranks[: len(a)], ranks[len(a):]), False
