"""Cross-query elimination-message cache.

The message (and psi) an elimination step emits is fully determined by the
step's *subtree fingerprint* (repro/plan/ir.py::step_fingerprints): the
source-potential closure hanging below its separator — occurrence structure
x per-table content versions x dictionary-domain content, the eliminated
variable, the separator sequence, and the psi-needed flag.  Real workloads
(JOB-style star/snowflake suites) are overlapping query sets that share
dimension subtrees; memoizing messages under that fingerprint turns every
shared subtree into work done once, fleet-wide:

* **version-aware by construction** — a `Table.append` changes the table's
  content version, which changes every fingerprint in the append's closure;
  stale messages are never *served*, only evicted (LRU) or explicitly
  dropped via `invalidate(table)`;
* **byte-budgeted** — LRU over resident entries; when constructed with a
  ``summary_cache``, the budget *pool* is shared with `SummaryCache`
  accounting (messages compete against resident summaries for the same
  bytes, summaries always win: only messages are evicted from here);
* **disk spill** — evictions optionally spill through the storage codec
  (repro/core/storage.py `_BlobWriter` container, magic ``GJM1``) so a
  re-probe pays a load, not a product;
* **single-flight per key** — concurrent builds needing the same message
  compute it exactly once: the first prober leads, the rest wait on the
  leader's latch and adopt the published entry (with a timeout fallback to
  computing locally, so a stuck leader can only delay, never wedge);
* entries store psi/message with the *producer's* variable names; the
  fingerprint pins the separator sequence positionally, so a consumer
  adopts them by positional rename (`adopt`) — arrays are shared, never
  copied, and treated as immutable by every downstream consumer.

Reuse is refused upstream for ``record_trace`` builds (incremental refresh
replays per-step wiring and must own its messages' provenance) and for
bagged (hybrid WCOJ) plans (bag potentials merge occurrences outside the
step wiring the fingerprint simulates) — see DESIGN.md §20.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.elimination import Psi
from repro_torch.core.potentials import Factor
from repro_torch.core.storage import _BlobWriter, _open_container, default_codec
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span

_MAGIC = b"GJM1"
_VERSION = 1


@dataclass
class CachedMessage:
    """One memoized elimination step: the message, and the psi when the
    eliminated variable is an output variable (fingerprint's psi flag)."""

    message: Factor
    psi: Optional[Psi]

    def nbytes(self) -> int:
        n = int(self.message.keys.nbytes + self.message.bucket.nbytes
                + self.message.fac.nbytes)
        if self.psi is not None:
            n += self.psi.nbytes()
        return n


@dataclass
class MsgCacheStats:
    hits: int = 0            # served from memory
    disk_hits: int = 0       # served from spill
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    spills: int = 0
    waits: int = 0           # followers served by a leader's publish
    timeouts: int = 0        # followers that computed locally after waiting
    invalidations: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class _Flight:
    """Single-flight latch for one message key."""

    __slots__ = ("event",)

    def __init__(self) -> None:
        self.event = threading.Event()


def _entry_to_bytes(entry: CachedMessage) -> bytes:
    """Serialize through the storage codec container (spill format)."""
    w = _BlobWriter(default_codec(), 3)
    msg = entry.message
    w.add("msg_keys", np.ascontiguousarray(msg.keys))
    w.add("msg_bucket", np.ascontiguousarray(msg.bucket))
    w.add("msg_fac", np.ascontiguousarray(msg.fac))
    manifest: Dict[str, object] = {
        "msg_vars": len(msg.vars),
        "msg_sizes": [int(s) for s in msg.sizes],
        "has_psi": entry.psi is not None,
    }
    if entry.psi is not None:
        p = entry.psi
        w.add("psi_parent_keys", np.ascontiguousarray(p.parent_keys))
        w.add("psi_start", np.ascontiguousarray(p.start))
        w.add("psi_count", np.ascontiguousarray(p.count))
        w.add("psi_child_codes", np.ascontiguousarray(p.child_codes))
        w.add("psi_bucket", np.ascontiguousarray(p.bucket))
        w.add("psi_fac", np.ascontiguousarray(p.fac))
        manifest["psi_parent_sizes"] = [int(s) for s in p.parent_sizes]
        manifest["psi_child_size"] = int(p.child_size)
    return w.finish(_MAGIC, _VERSION, manifest)


def _entry_from_bytes(data: bytes) -> CachedMessage:
    _, manifest, get = _open_container(data, _MAGIC, "message-cache entry")
    k = int(manifest["msg_vars"])
    # positional placeholder names; `adopt` renames to the consumer's vars
    mvars = tuple(f"_{i}" for i in range(k))
    msg = Factor(mvars, get("msg_keys"), get("msg_bucket"),
                 get("msg_fac"), tuple(manifest["msg_sizes"]))
    psi = None
    if manifest.get("has_psi"):
        ps = tuple(int(s) for s in manifest["psi_parent_sizes"])
        psi = Psi("_c", tuple(f"_{i}" for i in range(len(ps))),
                  get("psi_parent_keys"), get("psi_start"),
                  get("psi_count"), get("psi_child_codes"),
                  get("psi_bucket"), get("psi_fac"),
                  ps, int(manifest["psi_child_size"]))
    return CachedMessage(message=msg, psi=psi)


class MessageCache:
    """Thread-safe LRU store of elimination messages, keyed by subtree
    fingerprint, with byte budget, optional disk spill, and single-flight.

    ``summary_cache`` (a `repro_torch.summary.cache.SummaryCache`) switches the
    byte accounting to a *shared pool*: the budget is the summary cache's
    ``byte_budget`` and this cache's usage is charged on top of the
    summaries' resident bytes — so hot summaries squeeze messages out, and
    a standalone deployment can still size the message cache independently
    via ``byte_budget``.
    """

    def __init__(self, byte_budget: int = 64 << 20,
                 spill_dir: Optional[str] = None,
                 summary_cache=None,
                 flight_timeout: float = 30.0) -> None:
        if byte_budget <= 0:
            raise ValueError("byte_budget must be positive")
        self.byte_budget = int(byte_budget)
        self.spill_dir = spill_dir
        self.summary_cache = summary_cache
        self.flight_timeout = float(flight_timeout)
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._entries: "Dict[str, CachedMessage]" = {}
        self._lru: List[str] = []          # oldest first
        self._nbytes: Dict[str, int] = {}
        self._tables: Dict[str, FrozenSet[str]] = {}
        self._flights: Dict[str, _Flight] = {}
        self._lock = threading.RLock()
        self.stats = MsgCacheStats()

    def _bump(self, stat: str, n: int = 1) -> None:
        """Increment a stats field and mirror it into the process metrics
        registry (``msgcache.<stat>``) — one write, two views."""
        setattr(self.stats, stat, getattr(self.stats, stat) + n)
        REGISTRY.counter(f"msgcache.{stat}").inc(n)

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._nbytes.values())

    def _budget_used(self) -> int:
        """Bytes charged against the pool (lock held)."""
        used = sum(self._nbytes.values())
        if self.summary_cache is not None:
            used += self.summary_cache.resident_bytes
        return used

    def _budget_limit(self) -> int:
        if self.summary_cache is not None:
            return int(self.summary_cache.byte_budget)
        return self.byte_budget

    def resident_keys(self) -> FrozenSet[str]:
        """Snapshot of the fingerprints currently answerable without a
        product — memory-resident plus spilled.  The planner's residency
        pricing (`CostModel.apply_residency`) probes against this."""
        with self._lock:
            keys = set(self._entries)
        if self.spill_dir is not None:
            try:
                for name in os.listdir(self.spill_dir):
                    if name.endswith(".gjm"):
                        keys.add(name[:-4])
            except OSError:
                pass
        return frozenset(keys)

    def _spill_path(self, key: str) -> Optional[str]:
        if self.spill_dir is None:
            return None
        return os.path.join(self.spill_dir, f"{key}.gjm")

    # -- lookup / single-flight -------------------------------------------
    def get(self, key: str) -> Optional[CachedMessage]:
        """Memory first, then spill; None on a true miss.  Counts stats."""
        entry, _ = self._get_counted(key)
        return entry

    def _get_counted(self, key: str) -> Tuple[Optional[CachedMessage], str]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._lru.remove(key)
                self._lru.append(key)
                self._bump("hits")
                return hit, "memory"
            path = self._spill_path(key)
        if path is not None and os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    entry = _entry_from_bytes(f.read())
            except (OSError, ValueError):
                entry = None
            if entry is not None:
                with self._lock:
                    if not os.path.exists(path):
                        # invalidate() raced the load: entry declared stale
                        self._bump("misses")
                        return None, "miss"
                    self._bump("disk_hits")
                    spills = self._admit(key, entry)
                self._write_spills(spills)
                return entry, "disk"
        with self._lock:
            self._bump("misses")
        return None, "miss"

    def lookup_or_begin(self, key: str
                        ) -> Tuple[Optional[CachedMessage], Optional[_Flight]]:
        """Single-flight probe: ``(entry, None)`` on a hit; ``(None,
        flight)`` when the caller becomes the leader for ``key`` and must
        `publish` (or `abandon`) it; ``(None, None)`` when a wait on
        another leader timed out — compute locally, publish nothing.

        A follower whose leader publishes adopts the published entry
        (counted as a ``wait``).  Leaders never nest: a build computes its
        steps sequentially and resolves each flight before probing the
        next key, so follower waits cannot deadlock.
        """
        deadline = time.monotonic() + self.flight_timeout
        while True:
            with self._lock:
                if key in self._entries:
                    entry, _ = self._get_counted(key)
                    if entry is not None:
                        return entry, None
                flight = self._flights.get(key)
                if flight is None:
                    # nobody is computing this key: probe spill, else lead
                    pass
                else:
                    wait_for = flight
            if flight is None:
                entry, source = self._get_counted(key)
                if entry is not None:
                    return entry, None
                with self._lock:
                    # somebody may have started (or finished) while we
                    # probed the disk outside the lock
                    if key in self._entries:
                        entry, _ = self._get_counted(key)
                        if entry is not None:
                            return entry, None
                    flight = self._flights.get(key)
                    if flight is None:
                        flight = _Flight()
                        self._flights[key] = flight
                        return None, flight
                    wait_for = flight
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not wait_for.event.wait(timeout=remaining):
                with self._lock:
                    self._bump("timeouts")
                return None, None
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._lru.remove(key)
                    self._lru.append(key)
                    self._bump("waits")
                    return entry, None
                # leader abandoned (or the entry was instantly evicted):
                # retry — either lead ourselves or find a new leader
                continue

    def publish(self, key: str, flight: Optional[_Flight],
                psi: Optional[Psi], message: Factor,
                tables: Iterable[str] = ()) -> None:
        """Insert the computed step and release the key's latch (if any).

        Values are stored as references — callers and downstream consumers
        must treat the arrays as immutable (every Factor/Psi operation in
        this codebase already copies on write).
        """
        entry = CachedMessage(message=message, psi=psi)
        with self._lock:
            self._bump("puts")
            self._tables[key] = frozenset(tables)
            spills = self._admit(key, entry)
            if flight is not None and self._flights.get(key) is flight:
                del self._flights[key]
        if flight is not None:
            flight.event.set()
        self._write_spills(spills)

    def abandon(self, key: str, flight: Optional[_Flight]) -> None:
        """Release a leader's latch without publishing (compute failed)."""
        if flight is None:
            return
        with self._lock:
            if self._flights.get(key) is flight:
                del self._flights[key]
        flight.event.set()

    @staticmethod
    def adopt(entry: CachedMessage, child: str, parents: Sequence[str]
              ) -> Tuple[Optional[Psi], Factor]:
        """Rename a cached step to the consumer's variable names.

        The fingerprint pins the separator *sequence*, so the rename is
        positional: cached message/psi columns line up 1:1 with the
        consumer's ``parents``.  Arrays are shared (no copy).
        """
        msg = entry.message
        if len(parents) != len(msg.vars):
            raise ValueError(
                f"cached message arity {len(msg.vars)} != separator arity "
                f"{len(parents)} — fingerprint collision?")
        message = Factor(tuple(parents), msg.keys, msg.bucket, msg.fac,
                         msg.sizes)
        psi = None
        if entry.psi is not None:
            psi = replace(entry.psi, child=child, parents=tuple(parents))
        return psi, message

    # -- admission / eviction ---------------------------------------------
    def _admit(self, key: str, entry: CachedMessage) -> List[Tuple]:
        """Insert/refresh + shrink (lock held); returns deferred spills."""
        if key in self._entries:
            self._lru.remove(key)
        self._entries[key] = entry
        self._lru.append(key)
        self._nbytes[key] = entry.nbytes()
        return self._shrink(keep=key)

    def _shrink(self, keep: Optional[str] = None) -> List[Tuple]:
        """Evict LRU entries until the (possibly shared) budget holds
        (lock held).  The entry named by ``keep`` survives even if the
        pool alone exceeds the budget — an oversized message is still
        better served hot once.  Spill writes are deferred and returned
        for `_write_spills` to run outside the lock."""
        pending: List[Tuple] = []
        limit = self._budget_limit()
        while self._budget_used() > limit and len(self._entries) > 1:
            victim = self._lru[0]
            if victim == keep:
                if len(self._lru) < 2:
                    break
                victim = self._lru[1]
            self._lru.remove(victim)
            entry = self._entries.pop(victim)
            self._nbytes.pop(victim, None)
            self._bump("evictions")
            path = self._spill_path(victim)
            if path is None:
                self._tables.pop(victim, None)
            elif not os.path.exists(path):
                pending.append((victim, entry, path))
                # provenance stays: the spill file (about to exist) needs it
        return pending

    def _write_spills(self, pending: List[Tuple]) -> None:
        for key, entry, path in pending:
            with self._lock:
                if key not in self._tables:
                    continue   # invalidated after eviction: declared stale
            with _span("msgcache:spill", cat="msgcache", key=key):
                data = _entry_to_bytes(entry)
                tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)        # atomic publish
            with self._lock:
                self._bump("spills")

    # -- invalidation ------------------------------------------------------
    def invalidate(self, table: str) -> int:
        """Drop every message recorded as derived from ``table``.

        Version-keyed fingerprints already guarantee an append never
        *serves* a stale message; this is the explicit override for tables
        mutated behind the catalog's back, and the hygiene hook
        `JoinService.invalidate` calls to reclaim dead bytes."""
        removed = 0
        with self._lock:
            for key, tabs in list(self._tables.items()):
                if table not in tabs:
                    continue
                hit = False
                if key in self._entries:
                    self._entries.pop(key)
                    self._nbytes.pop(key, None)
                    self._lru.remove(key)
                    hit = True
                path = self._spill_path(key)
                if path is not None and os.path.exists(path):
                    try:
                        os.remove(path)
                        hit = True
                    except OSError:
                        pass
                self._tables.pop(key, None)
                if hit:
                    removed += 1
            self._bump("invalidations", removed)
        return removed

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._lru.clear()
            self._nbytes.clear()
            self._tables.clear()
