"""Compute-and-reuse summary cache.

The paper's 100X+ wins come from storing the (tiny) GFJS and answering
later requests from it instead of re-joining.  :class:`SummaryCache` makes
that a service-grade component:

* keys are (canonical query fingerprint, content versions of every table
  occurrence, physical-plan signature) — replacing a base table invalidates
  exactly the summaries built on it, and summaries built under different
  elimination orders never collide; partitioned plans fold their shard
  scheme into the signature, so a ShardedGFJS and a monolithic summary of
  the same query are distinct entries that hit, spill, and reload alike
  (the storage container round-trips both, byte budgets read
  ``resident_nbytes()`` on either shape);
* a byte budget bounds resident summaries, LRU order decides eviction;
* evictions optionally *spill* to disk through the GFJS container format
  (repro/core/storage.py), so a later request pays a load, not a re-join;
* every public operation takes the cache lock, so one cache may serve
  multiple threads (`JoinService` relies on this);
* entries may carry a TTL (seconds); expired residents are dropped on
  access, expired spill files (by mtime) are ignored and unlinked;
* `invalidate(table)` force-drops every entry recorded as built on a base
  table — the explicit override for when content-version keying is not
  enough (e.g. a table mutated in place behind the catalog's back);
* `refresh(old_key, new_key, gfjs)` upgrades an entry in place — the
  commit point of incremental maintenance: retirement of the stale
  summary and admission of the refreshed one are atomic under the lock;
* hit/miss/eviction/expiry counters feed the service's observability.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from repro_torch.core.gfjs import GFJS
from repro_torch.core.storage import load_gfjs, save_gfjs
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span
from repro_torch.relational.query import JoinQuery
from repro_torch.relational.table import Catalog


def cache_key_for_versions(query: JoinQuery, versions, plan=None) -> str:
    """(query fingerprint [× plan signature], table versions) -> hex key.

    ``versions`` maps base-table name -> content version.  The incremental
    refresh path keys the upgraded summary on the versions its delta chain
    ends at, which may already trail the live catalog by a racing append.
    """
    h = hashlib.sha256(query.fingerprint(plan=plan).encode())
    for name in sorted({qt.table for qt in query.tables}):
        h.update(name.encode())
        h.update(versions[name].encode())
    return h.hexdigest()


def cache_key(query: JoinQuery, catalog: Catalog, plan=None) -> str:
    """`cache_key_for_versions` against the catalog's current versions."""
    return cache_key_for_versions(
        query, {qt.table: catalog[qt.table].version() for qt in query.tables},
        plan=plan)


@dataclass
class CacheStats:
    hits: int = 0            # served from memory
    disk_hits: int = 0       # served from spill
    misses: int = 0
    evictions: int = 0
    spills: int = 0
    puts: int = 0
    expirations: int = 0     # TTL drops (resident or spill)
    invalidations: int = 0   # entries dropped by invalidate()
    refreshes: int = 0       # upgrade-in-place via refresh()

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class SummaryCache:
    """Thread-safe LRU GFJS store with byte budget, TTL, and disk spill."""

    def __init__(self, byte_budget: int = 256 << 20,
                 spill_dir: Optional[str] = None,
                 ttl_seconds: Optional[float] = None) -> None:
        if byte_budget <= 0:
            raise ValueError("byte_budget must be positive")
        if ttl_seconds is not None and ttl_seconds <= 0:
            raise ValueError("ttl_seconds must be positive (or None)")
        self.byte_budget = int(byte_budget)
        self.spill_dir = spill_dir
        self.ttl_seconds = ttl_seconds
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._entries: "OrderedDict[str, GFJS]" = OrderedDict()
        self._nbytes: Dict[str, int] = {}
        self._born: Dict[str, float] = {}                # key -> creation time
        self._tables: Dict[str, FrozenSet[str]] = {}     # key -> base tables
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def _bump(self, stat: str, n: int = 1) -> None:
        """Increment a CacheStats field and mirror it into the process
        metrics registry (``cache.<stat>``) — one write, two views."""
        setattr(self.stats, stat, getattr(self.stats, stat) + n)
        REGISTRY.counter(f"cache.{stat}").inc(n)

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._nbytes.values())

    def _spill_path(self, key: str) -> Optional[str]:
        if self.spill_dir is None:
            return None
        return os.path.join(self.spill_dir, f"{key}.gfjs")

    # -- TTL ---------------------------------------------------------------
    # TTL measures age since *computation* (the original put), not since the
    # last promotion or eviction: `_born` carries the wall-clock creation
    # time for resident entries and spill files store the same instant as
    # their mtime (os.utime on write), so the clock survives
    # evict/promote cycles in both directions.

    def _expired(self, born: float) -> bool:
        return (self.ttl_seconds is not None
                and time.time() - born > self.ttl_seconds)

    def _drop(self, key: str) -> None:
        """Remove a resident entry (lock held)."""
        self._entries.pop(key, None)
        self._nbytes.pop(key, None)
        self._born.pop(key, None)
        self._prune_provenance(key)

    def _prune_provenance(self, key: str) -> None:
        """Drop the key's table provenance unless a spill file still needs
        it (lock held) — keeps `_tables` from growing without bound as
        version churn mints ever-new keys."""
        path = self._spill_path(key)
        if path is None or not os.path.exists(path):
            self._tables.pop(key, None)

    def probe(self, key: str) -> str:
        """Non-mutating presence check: ``"memory" | "disk" | "miss"``.

        No promotion, no LRU bump, no stats — the :class:`JoinServer`
        admission gate asks whether a request *would* be a cold build
        without perturbing the cache it is pricing.  TTL is respected
        (an expired entry reads as a miss) but expiry is not acted on;
        the next real ``get`` does the dropping.
        """
        with self._lock:
            if key in self._entries \
                    and not self._expired(self._born.get(key, 0.0)):
                return "memory"
            path = self._spill_path(key)
        if path is not None and os.path.exists(path):
            try:
                if not self._expired(os.path.getmtime(path)):
                    return "disk"
            except OSError:      # raced an unlink between exists and stat
                pass
        return "miss"

    # -- core API ----------------------------------------------------------
    def get(self, key: str) -> Optional[GFJS]:
        """Memory first, then spill; None on a true miss or TTL expiry."""
        return self.get_with_source(key)[0]

    def get_with_source(self, key: str) -> Tuple[Optional[GFJS], str]:
        """(gfjs, "memory" | "disk") on a hit; (None, "miss") otherwise.

        The source tier is determined by *this* lookup, not inferred from
        shared counters — concurrent requests cannot mislabel each other.
        """
        with _span("cache:get", cat="cache") as sp:
            gfjs, source = self._get_with_source(key)
            sp.set(source=source)
            return gfjs, source

    def _get_with_source(self, key: str) -> Tuple[Optional[GFJS], str]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                if self._expired(self._born.get(key, 0.0)):
                    self._drop(key)
                    self._bump("expirations")
                else:
                    self._entries.move_to_end(key)
                    # re-measure: expansion caches (_bounds / _launch) grow
                    # lazily after admission, and the byte budget must see
                    # them — O(levels) per hit, settled at the next shrink
                    self._nbytes[key] = hit.resident_nbytes()
                    self._bump("hits")
                    return hit, "memory"
            path = self._spill_path(key)
            load_from: Optional[str] = None
            born = 0.0
            if path is not None and os.path.exists(path):
                born = os.path.getmtime(path)
                if self._expired(born):
                    os.remove(path)
                    self._prune_provenance(key)
                    self._bump("expirations")
                else:
                    load_from = path
            if load_from is None:
                self._bump("misses")
                return None, "miss"
        # disk I/O happens outside the lock: a slow spill promotion must not
        # stall every other thread's memory hits.  Two threads promoting the
        # same key both load; the second _admit is an idempotent replace.
        try:
            gfjs = load_gfjs(load_from)
        except FileNotFoundError:      # raced with invalidate()/expiry
            with self._lock:
                self._bump("misses")
            return None, "miss"
        with self._lock:
            if not os.path.exists(load_from):
                # invalidate() removed the file while we were loading: the
                # summary we hold is stale — do NOT resurrect it
                self._bump("misses")
                return None, "miss"
            self._bump("disk_hits")
            spills = self._admit(key, gfjs, born=born)
        self.write_spills(spills)
        return gfjs, "disk"

    def put(self, key: str, gfjs: GFJS,
            tables: Optional[Iterable[str]] = None) -> None:
        """Insert/refresh an entry; ``tables`` names the base tables it was
        built on (enables `invalidate`)."""
        with _span("cache:put", cat="cache"):
            with self._lock:
                self._bump("puts")
                if tables is not None:
                    self._tables[key] = frozenset(tables)
                spills = self._admit(key, gfjs, born=time.time())
            self.write_spills(spills)

    def refresh(self, old_key: str, new_key: str, gfjs: GFJS,
                tables: Optional[Iterable[str]] = None,
                defer_spill: bool = False) -> List[Tuple]:
        """Upgrade an entry in place: retire ``old_key``, admit ``new_key``.

        The incremental-maintenance commit point: both the retirement of
        the stale summary (resident entry, spill file, provenance) and the
        admission of the refreshed one happen under one lock acquisition,
        so a concurrent reader observes either the old-consistent or the
        new-consistent summary — never a half-spliced mix, and never a
        window where a get on the old key could resurrect stale state from
        a promotion in flight (`invalidate` races are handled identically:
        provenance for ``old_key`` is gone before the lock is released).

        With ``defer_spill=True`` the eviction spill work this admission
        may trigger is *returned* instead of written — for callers
        (``JoinService._try_refresh``) that must commit under a lock of
        their own and stage the disk I/O outside it via
        :meth:`write_spills`.  Returns the pending spill work either way
        (empty when already written).
        """
        with _span("cache:refresh", cat="cache"), self._lock:
            self._bump("refreshes")
            if old_key != new_key:
                self._entries.pop(old_key, None)
                self._nbytes.pop(old_key, None)
                self._born.pop(old_key, None)
                path = self._spill_path(old_key)
                if path is not None and os.path.exists(path):
                    os.remove(path)
                self._tables.pop(old_key, None)
            if tables is not None:
                self._tables[new_key] = frozenset(tables)
            spills = self._admit(new_key, gfjs, born=time.time())
        if defer_spill:
            return spills
        self.write_spills(spills)
        return []

    def invalidate(self, table: str) -> int:
        """Drop every entry recorded as built on ``table``.

        Covers resident entries and their spill files; returns the number
        of entries removed.  Only entries `put` with ``tables`` provenance
        in this process are discoverable — version-keyed misses already
        handle tables replaced *through* the catalog.
        """
        removed = 0
        with self._lock:
            for key, tabs in list(self._tables.items()):
                if table not in tabs:
                    continue
                hit = False
                if key in self._entries:
                    self._entries.pop(key)
                    self._nbytes.pop(key, None)
                    self._born.pop(key, None)
                    hit = True
                path = self._spill_path(key)
                if path is not None and os.path.exists(path):
                    os.remove(path)
                    hit = True
                self._tables.pop(key, None)
                if hit:                  # one logical entry, however stored
                    removed += 1
            self._bump("invalidations", removed)
        return removed

    def _admit(self, key: str, gfjs: GFJS, *, born: float) -> List[Tuple]:
        """Insert/refresh + shrink (lock held); returns deferred spill work."""
        self._entries[key] = gfjs      # replace on re-put, insert otherwise
        self._entries.move_to_end(key)
        self._nbytes[key] = gfjs.resident_nbytes()
        self._born[key] = born
        return self._shrink(keep=key)

    def _shrink(self, keep: Optional[str] = None) -> List[Tuple]:
        """Evict LRU entries until the byte budget holds (lock held).

        The entry named by ``keep`` survives even if it alone exceeds the
        budget (an oversized summary is still better served hot once).
        Spill *writes* are deferred: this returns (key, gfjs, path, born)
        work items for `write_spills` to run after the lock is released —
        serializing a large GFJS must not stall other threads' memory hits.
        """
        pending: List[Tuple] = []
        while sum(self._nbytes.values()) > self.byte_budget \
                and len(self._entries) > 1:
            victim = next(iter(self._entries))
            if victim == keep:
                # keep must stay; evict the next-oldest instead
                it = iter(self._entries)
                next(it)
                victim = next(it)
            gfjs = self._entries.pop(victim)
            self._nbytes.pop(victim)
            born = self._born.pop(victim, time.time())
            self._bump("evictions")
            path = self._spill_path(victim)
            if path is None:
                self._tables.pop(victim, None)   # nothing left to invalidate
            elif not os.path.exists(path):
                pending.append((victim, gfjs, path, born,
                                victim in self._tables))
                # provenance stays: the spill file (about to exist) needs it
        return pending

    def write_spills(self, pending: List[Tuple]) -> None:
        """Run deferred spill writes (no lock held during disk I/O).

        Writes go to a temp path and are renamed into place, so a reader
        never sees a half-written container: until `os.replace`, the final
        path simply does not exist and `get` reports a miss.
        """
        for key, gfjs, path, born, had_tables in pending:
            with self._lock:
                # invalidate() popped the provenance after eviction: this
                # summary was declared stale — do not write it back
                if had_tables and key not in self._tables:
                    continue
            with _span("cache:spill", cat="cache", key=key):
                tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
                save_gfjs(gfjs, tmp)
                os.utime(tmp, (born, born))  # spill mtime == creation time
                os.replace(tmp, path)        # atomic publish
            with self._lock:
                self._bump("spills")

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._nbytes.clear()
            self._born.clear()
            self._tables.clear()
