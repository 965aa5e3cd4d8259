"""Algorithms 3/4 — GFJS generation — plus the GFJS structure itself.

The paper generates the summary tuple-recursively (rec_GFJS).  We run the
level-synchronous equivalent: a *frontier* table holds every generated
prefix (one row per distinct value combination of the variables produced so
far) together with its running bucket product ``p_bucket``.  Expanding one
conditional factor ``psi`` maps each frontier row to its CSR group and emits
``count`` child rows — an exclusive-scan + expand-gather, the same primitive
as RLE desummarization (and the Pallas kernel `expand_gather` on TPU).

Per Algorithm 4 the RLE frequency emitted at a level is
``p_bucket * (prod buckets of the level) * (prod facs of the level)`` and the
frontier continues with ``p_bucket * (prod buckets)``; several psis in one
level combine by Cartesian product (their buckets and facs both multiply).

Because psi entries are sorted by (parent key, child value) and expansion is
order-preserving, every level is emitted in lexicographic prefix order —
which is exactly what makes the per-level RLE columns mutually aligned and
equal to the RLE of the fully sorted join result (Definition 1).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.elimination import Generator, Psi
from repro_torch.core.potentials import INT, _rank_rows_joint
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span
from repro_torch.relational.encoding import Domain


class LevelSummary:
    """One GFJS level: RLE runs for the variables introduced at this level.

    ``key_cols`` (var -> codes per run) and ``freq`` (run lengths; sums to
    join_size) are numpy arrays.  A level made by :meth:`deferred` holds
    them elsewhere (on the device, for ``engine.generate_gfjs``) and fills
    them on the first read of either: ``fetch`` runs once, under the
    level's lock, and is dropped after, with whatever it referenced.
    ``num_runs`` and :meth:`nbytes` never fetch; pickling or copying a
    level fetches it first.
    """

    def __init__(self, vars: Tuple[str, ...], key_cols: Dict[str, np.ndarray],
                 freq: np.ndarray) -> None:
        self.vars = vars
        self._key_cols = key_cols
        self._freq = freq
        self._num_runs = len(freq)
        self._fetch: Optional[Callable[[], tuple]] = None

    @classmethod
    def deferred(cls, vars: Sequence[str], num_runs: int,
                 fetch: Callable[[], Tuple[Dict[str, np.ndarray], np.ndarray]]
                 ) -> "LevelSummary":
        """A level of ``num_runs`` runs whose arrays ``fetch()`` returns as
        ``(key_cols, freq)``, int64, on the first read."""
        lvl = cls.__new__(cls)
        lvl.vars, lvl._key_cols, lvl._freq = tuple(vars), None, None
        lvl._num_runs, lvl._fetch = int(num_runs), fetch
        lvl._lock = threading.Lock()
        return lvl

    def _mirror(self) -> None:
        if self._fetch is None:
            return
        with self._lock:
            if self._fetch is not None:
                # key_cols, then freq, then no fetch: a reader that sees
                # either of the last two sees key_cols
                key_cols, freq = self._fetch()
                self._key_cols = key_cols
                self._freq = freq
                self._fetch = None

    @property
    def key_cols(self) -> Dict[str, np.ndarray]:
        self._mirror()
        return self._key_cols

    @property
    def freq(self) -> np.ndarray:
        self._mirror()
        return self._freq

    @property
    def num_runs(self) -> int:
        return self._num_runs

    def nbytes(self) -> int:
        if self._freq is None:   # not fetched: the int64 arrays it will hold
            return self._num_runs * 8 * (len(self.vars) + 1)
        return int(sum(v.nbytes for v in self._key_cols.values())
                   + self._freq.nbytes)

    def __reduce__(self):
        return LevelSummary, (self.vars, self.key_cols, self.freq)

    def __repr__(self) -> str:
        state = "deferred" if self._freq is None else "on the host"
        return (f"LevelSummary(vars={self.vars!r}, "
                f"num_runs={self.num_runs}, {state})")


@dataclass
class GFJS:
    """Grouped Frequentist Join Summary (Definition 1)."""

    levels: List[LevelSummary]
    column_order: List[str]
    join_size: int
    domains: Dict[str, Domain]
    _bounds: Dict[int, np.ndarray] = field(default_factory=dict, repr=False)
    # the level's launch data on the device: level -> (device, (bounds or
    # None, codes [K, runs])), int32 tensors; None bounds mark an identity
    # level (one run per row), None codes a level whose codes pass int32.
    # One entry per level (another device replaces it), filled by
    # repro_torch.core.engine.generate_gfjs or lazily by
    # repro_torch.kernels.ops.gfjs_launch (this module stays torch-free).
    # A generated level's host arrays are a deferred mirror of its entry
    # (LevelSummary.deferred), fetched on their first read
    _launch: Dict[int, tuple] = field(default_factory=dict, repr=False)

    def __getstate__(self) -> dict:
        # the memo stays in its process: a GFJS read back uploads each
        # level on its first launch, as one loaded from storage does
        return {**self.__dict__, "_launch": {}}

    @property
    def num_columns(self) -> int:
        return len(self.column_order)

    def nbytes(self) -> int:
        return int(sum(l.nbytes() for l in self.levels))

    def num_runs(self) -> int:
        return int(sum(l.num_runs for l in self.levels))

    def bounds(self, level: int) -> np.ndarray:
        """Cached inclusive prefix sums of a level's run lengths.

        Lockless: concurrent callers may both compute and one insert wins
        (the arrays are identical).  Return the local value, never re-read
        the dict — a concurrent eviction between insert and read would
        KeyError otherwise.
        """
        b = self._bounds.get(level)
        if b is None:
            b = np.cumsum(self.levels[level].freq)
            self._bounds[level] = b
        return b

    def aux_nbytes(self) -> int:
        """Bytes held by the lazily-built expansion caches.

        ``_bounds`` prefix sums plus ``_launch`` kernel metadata — bounded
        (one entry per level each) but invisible to :meth:`nbytes`, which
        stays the *serialized* summary size (the paper's Table-4 metric).
        """
        # other threads holding this GFJS insert into these dicts lockless
        # (via bounds()/gfjs_expand_meta), so snapshot the KEYS first and
        # re-fetch each entry with .get(): a key list is detached from the
        # dict the instant it is built, whereas iterating values()/items()
        # views — even wrapped in list() — keys off dict internals that a
        # concurrent insert may resize.  An entry replaced mid-walk yields
        # its new value; one racing in/out is simply skipped — either way
        # the measurement stays a valid point-in-time bound, never a
        # "dict changed size during iteration"
        n = 0
        for lvl in list(self._bounds):
            b = self._bounds.get(lvl)
            if b is not None:
                n += int(b.nbytes)
        for lvl in list(self._launch):
            entry = self._launch.get(lvl)
            if entry is None:
                continue
            _, meta = entry
            n += sum(int(getattr(a, "nbytes", 0)) for a in meta)
        return int(n)

    def resident_nbytes(self) -> int:
        """In-memory footprint: summary arrays + expansion caches (what a
        byte-budgeted cache should charge for a resident entry)."""
        return self.nbytes() + self.aux_nbytes()


@dataclass
class ShardedGFJS:
    """A hash-partitioned GFJS: one independent summary per shard.

    The join result is partitioned by ``hash(code(partition_var)) %
    num_partitions`` (repro/dist/partition.py): every base potential
    containing the partition variable is restricted to the shard's hash
    slice and every other potential is replicated, so each shard's GFJS
    summarizes exactly the join rows whose partition-variable value hashes
    to it.  The shards are disjoint and their union is the full result —
    row counts and distributive aggregates are sums over shards, and
    nothing here ever materializes a concatenated summary.

    All shards run under the same physical plan, so ``column_order`` and
    the per-level variable structure are identical across shards (factor
    schemas — not data — determine both); the merge logic in
    repro/summary/algebra.py relies on that.
    """

    shards: List[GFJS]
    column_order: List[str]
    join_size: int
    domains: Dict[str, Domain]
    partition_var: str
    salt: int = 0

    @property
    def num_partitions(self) -> int:
        return len(self.shards)

    @property
    def num_columns(self) -> int:
        return len(self.column_order)

    def shard_sizes(self) -> List[int]:
        return [s.join_size for s in self.shards]

    def nbytes(self) -> int:
        return int(sum(s.nbytes() for s in self.shards))

    def num_runs(self) -> int:
        return int(sum(s.num_runs() for s in self.shards))

    def aux_nbytes(self) -> int:
        return int(sum(s.aux_nbytes() for s in self.shards))

    def resident_nbytes(self) -> int:
        return self.nbytes() + self.aux_nbytes()


def _lookup_groups(
    frontier_keys: np.ndarray, psi: Psi
) -> np.ndarray:
    """Group index in psi for each frontier row (-1 if absent)."""
    if len(psi.parents) == 0:
        return np.zeros(len(frontier_keys), INT)
    if len(psi.parent_keys) == 0:
        # empty psi: no parent group exists, so every frontier row misses;
        # never index pr[pos] on the zero-length array
        return np.full(len(frontier_keys), -1, INT)
    (fr, pr), _ = _rank_rows_joint(frontier_keys, psi.parent_keys,
                                   list(psi.parent_sizes))
    # psi.parent_keys rows are lex-sorted, and both rankings are
    # lex-order-consistent, so pr is sorted ascending.
    pos = np.searchsorted(pr, fr)
    pos = np.clip(pos, 0, len(pr) - 1)
    ok = pr[pos] == fr
    return np.where(ok, pos, -1).astype(INT)


def _expand(
    counts: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """src row index + within-group offset for an expansion by ``counts``.

    O(total) via repeat (the TPU path uses the `expand_gather` Pallas kernel,
    which re-derives src with a blocked binary search instead — see
    repro/kernels/expand_gather.py for why that's the right trade on TPU).
    """
    counts = np.asarray(counts, dtype=INT)
    offsets = np.cumsum(counts) - counts          # exclusive scan
    total = int(offsets[-1] + counts[-1]) if len(counts) else 0
    src = np.repeat(np.arange(len(counts), dtype=INT), counts)
    within = np.arange(total, dtype=INT) - offsets[src]
    return src, within


def expand_level(
    cols: Dict[str, np.ndarray], p_bucket: np.ndarray, level: Sequence[Psi]
) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray, Tuple[str, ...],
           List[Tuple[np.ndarray, np.ndarray]]]:
    """Expand one generator level over the current frontier.

    Returns ``(cols, p_bucket, freq, new_vars, cache)`` where ``cache``
    holds one ``(src, cidx)`` index pair per psi: ``src`` maps each output
    frontier row to its source row in the previous frontier state, ``cidx``
    to the psi entry it consumed.  When a base-table append changes psi
    *values* but not psi *structure*, replaying these gathers re-propagates
    the run weights without redoing any group lookup or expansion — the
    splice fast path of repro/summary/incremental.py.
    """
    fac_acc = np.ones(len(p_bucket), INT)
    new_vars: List[str] = []
    cache: List[Tuple[np.ndarray, np.ndarray]] = []
    for psi in level:
        pk = (np.stack([cols[p] for p in psi.parents], axis=1)
              if psi.parents else np.zeros((len(p_bucket), 0), INT))
        g = _lookup_groups(pk, psi)
        counts = np.zeros(len(g), INT)
        hit = g >= 0
        counts[hit] = psi.count[g[hit]]
        src, within = _expand(counts)
        cidx = psi.start[g[src]] + within
        cols = {v: a[src] for v, a in cols.items()}
        cols[psi.child] = psi.child_codes[cidx]
        p_bucket = p_bucket[src] * psi.bucket[cidx]
        fac_acc = fac_acc[src] * psi.fac[cidx]
        new_vars.append(psi.child)
        cache.append((src, cidx))
    return cols, p_bucket, p_bucket * fac_acc, tuple(new_vars), cache


def generate_gfjs(
    gen: Generator, domains: Dict[str, Domain],
    expansion_cache: Optional[List[List[Tuple[np.ndarray, np.ndarray]]]] = None,
) -> GFJS:
    """Run Algorithms 3/4 (level-synchronous) over the generator.

    ``expansion_cache`` (when a list is passed) collects the per-level
    ``(src, cidx)`` gather indices from :func:`expand_level` — the raw
    material of incremental weight re-propagation.
    """
    levels_out: List[LevelSummary] = [
        LevelSummary((gen.root,), {gen.root: gen.root_codes}, gen.root_freq)
    ]
    # frontier state
    cols: Dict[str, np.ndarray] = {gen.root: gen.root_codes}
    p_bucket = np.ones(len(gen.root_codes), INT)

    runs_hist = REGISTRY.histogram("gfjs.runs_per_level", unit="runs")
    runs_hist.observe(len(gen.root_codes))
    for depth, level in enumerate(gen.levels):
        with _span(f"gfjs:level:{depth}", cat="gen", backend="numpy",
                   depth=depth) as sp:
            cols, p_bucket, freq, new_vars, cache = expand_level(
                cols, p_bucket, level)
            sp.set(runs=len(freq), vars=",".join(new_vars))
        runs_hist.observe(len(freq))
        levels_out.append(LevelSummary(
            new_vars, {v: cols[v] for v in new_vars}, freq))
        if expansion_cache is not None:
            expansion_cache.append(cache)

    return GFJS(levels_out, list(gen.column_order), gen.join_size, domains)


# ---------------------------------------------------------------------------
# Desummarization (paper §3.6) — full, ranged, and streaming variants.
# ---------------------------------------------------------------------------

def rle_expand(values: np.ndarray, freq: np.ndarray) -> np.ndarray:
    """Expand RLE runs to a flat column (cost == join size, paper §3.5.1)."""
    return np.repeat(values, freq)


def desummarize(gfjs: "GFJS | ShardedGFJS", *, decode: bool = True
                ) -> Dict[str, np.ndarray]:
    """Materialize the full flat join result from the summary.

    A :class:`ShardedGFJS` expands shard by shard and concatenates in
    shard order — the row *multiset* equals the monolithic expansion, but
    rows arrive grouped by partition hash rather than globally sorted.
    """
    if isinstance(gfjs, ShardedGFJS):
        parts = [desummarize(s, decode=decode) for s in gfjs.shards]
        return {v: np.concatenate([p[v] for p in parts])
                for v in gfjs.column_order}
    out: Dict[str, np.ndarray] = {}
    for lvl in gfjs.levels:
        for v in lvl.vars:
            col = rle_expand(lvl.key_cols[v], lvl.freq)
            out[v] = gfjs.domains[v].decode(col) if decode else col
    return {v: out[v] for v in gfjs.column_order}


def desummarize_range(
    gfjs: "GFJS | ShardedGFJS", lo: int, hi: int, *, decode: bool = True
) -> Dict[str, np.ndarray]:
    """Materialize join-result rows [lo, hi) only — O((hi-lo) + log runs).

    Beyond-paper extension (DESIGN.md §7): GFJS run boundaries are prefix
    sums, so any row range is addressable without touching the rest of the
    result.  This is what makes GFJS range-shardable across a TPU mesh: each
    data host expands only its own slice.

    For a :class:`ShardedGFJS` the row space is the shard-concatenated
    order (shard 0's rows, then shard 1's, ...) — the same order
    :func:`desummarize` and :func:`stream_desummarize` emit — and a range
    resolves through the cumulative shard sizes to per-shard sub-ranges.
    """
    if isinstance(gfjs, ShardedGFJS):
        lo = max(0, int(lo))
        hi = min(int(hi), gfjs.join_size)
        parts: List[Dict[str, np.ndarray]] = []
        base = 0
        for shard in gfjs.shards:
            s_lo = max(lo - base, 0)
            s_hi = min(hi - base, shard.join_size)
            if s_lo < s_hi or not parts:   # keep >=1 part for dtypes
                parts.append(desummarize_range(
                    shard, s_lo, max(s_hi, s_lo), decode=decode))
            base += shard.join_size
        return {v: np.concatenate([p[v] for p in parts])
                for v in gfjs.column_order}
    lo = max(0, int(lo))
    hi = min(int(hi), gfjs.join_size)
    out: Dict[str, np.ndarray] = {}
    for li, lvl in enumerate(gfjs.levels):
        bounds = gfjs.bounds(li)
        first = int(np.searchsorted(bounds, lo, side="right"))
        last = int(np.searchsorted(bounds, hi - 1, side="right")) if hi > lo else first
        sl = slice(first, last + 1) if hi > lo else slice(first, first)
        freq = lvl.freq[sl].copy()
        if hi > lo and len(freq):
            start_of_first = int(bounds[first] - lvl.freq[first])
            freq[0] -= lo - start_of_first
            freq[-1] -= int(bounds[last]) - hi
        for v in lvl.vars:
            col = np.repeat(lvl.key_cols[v][sl], freq)
            out[v] = gfjs.domains[v].decode(col) if decode else col
    return {v: out[v] for v in gfjs.column_order}


def stream_desummarize(
    gfjs: "GFJS | ShardedGFJS", chunk_rows: int = 1 << 20, *,
    decode: bool = True
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield the join result in row chunks without full materialization.

    Sharded summaries stream shard by shard (chunk boundaries reset at
    shard edges; each chunk is still at most ``chunk_rows`` rows).
    """
    if isinstance(gfjs, ShardedGFJS):
        for shard in gfjs.shards:
            yield from stream_desummarize(shard, chunk_rows, decode=decode)
        return
    for lo in range(0, gfjs.join_size, chunk_rows):
        yield desummarize_range(gfjs, lo, min(lo + chunk_rows, gfjs.join_size),
                                decode=decode)


def row_at(gfjs: "GFJS | ShardedGFJS", t: int, *,
           decode: bool = True) -> Dict[str, object]:
    """O(levels * log runs) random access to join-result row ``t``.

    Sharded row space is the shard-concatenated order of
    :func:`desummarize`; the shard lookup adds O(num_partitions).
    """
    if not (0 <= t < gfjs.join_size):
        raise IndexError(t)
    if isinstance(gfjs, ShardedGFJS):
        for shard in gfjs.shards:
            if t < shard.join_size:
                return row_at(shard, t, decode=decode)
            t -= shard.join_size
        raise IndexError(t)  # pragma: no cover - join_size == sum invariant
    out: Dict[str, object] = {}
    for li, lvl in enumerate(gfjs.levels):
        bounds = gfjs.bounds(li)
        r = int(np.searchsorted(bounds, t, side="right"))
        for v in lvl.vars:
            code = lvl.key_cols[v][r]
            out[v] = gfjs.domains[v].decode(np.asarray([code]))[0] if decode else int(code)
    return {v: out[v] for v in gfjs.column_order}
