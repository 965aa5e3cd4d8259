"""Hash-partitioned Graphical Join execution (DESIGN.md §15).

The partition key falls out of the PGM view: pick one query variable
``v`` (by default the eliminated variable of the costliest planned step —
the bottleneck the shards should split), hash its dictionary codes, and

* restrict every base potential *containing* ``v`` to the rows whose
  ``v``-code hashes to the shard;
* replicate every potential that does not mention ``v``.

Every row of the full join result carries exactly one ``v`` value, so the
per-shard join results are disjoint and their union is the full result —
each shard runs the *same* message-passing steps independently, no
cross-shard communication until the (cheap, summary-level) merge.  This is
the classic distributed hash join generalized to the whole elimination
DAG: steps whose inputs are reachable from a ``v``-carrying potential do
``1/k``-th of the work per shard; steps independent of ``v`` are
replicated (DESIGN.md §15 discusses when that trade is worth it).

Port of ``src/repro/dist/partition.py``.  The host side — the hash, the
planners, ``partition_encoded`` and ``parallel_desummarize`` — is the
reference's numpy, verbatim.  The device side runs on one torch device
instead of a jax mesh: :func:`hash_partition_device` is a torch twin of
:func:`hash_partition`, bit-identical to it, and
:func:`sharded_potential_counts` / :func:`partition_histogram` are one
``torch.bincount`` there (each raises for ``device="cuda"`` without a
card).  Given a ``torch.distributed`` device mesh, each rank counts its
own slice of the codes and an all-reduce SUM over the mesh axis's
process group gives every rank the global histogram, as the reference's
``psum`` over the axis does.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import engine
from repro_torch.core.gfjs import (GFJS, ShardedGFJS, desummarize,
                                   desummarize_range)
from repro_torch.core.potentials import INT
from repro_torch.obs.trace import span as _span
from repro_torch.relational.encoding import EncodedQuery

# Knuth multiplicative constant (2^32 / phi); the hash must be identical
# in numpy uint32 and torch int64 arithmetic so host- and device-side
# partition decisions can never disagree.
HASH_MULT = 0x9E3779B1
_MASK32 = 0xFFFFFFFF


def hash_partition(codes, num_partitions: int, *, salt: int = 0) -> np.ndarray:
    """Partition id in [0, num_partitions) per dictionary code (numpy).

    uint32 multiplicative hash + xor-fold: codes are dense domain indices,
    so plain modulo would map contiguous code ranges to round-robin shards
    and correlate with value order; the multiply decorrelates.
    """
    if num_partitions <= 0:
        raise ValueError("num_partitions must be positive")
    h = np.asarray(codes).astype(np.uint32)
    h = (h + np.uint32(salt & 0xFFFFFFFF)) * np.uint32(HASH_MULT)
    h ^= h >> np.uint32(16)
    return (h % np.uint32(num_partitions)).astype(INT)


def hash_partition_device(codes, num_partitions: int, *, salt: int = 0,
                          device: Union[str, torch.device] = "cuda"
                          ) -> torch.Tensor:
    """Torch twin of :func:`hash_partition`, bit-identical to it, as int32
    on ``device``.

    torch's ``uint32`` has few operations, and a 32 x 32-bit product
    overflows int64, so the uint32 arithmetic runs in int64 under
    ``& 0xFFFFFFFF`` masks, with ``HASH_MULT`` split into 16-bit halves so
    that no product passes 2^48.
    """
    if num_partitions <= 0:
        raise ValueError("num_partitions must be positive")
    dev = engine.resolve_device(device)
    h = torch.as_tensor(codes).to(device=dev, dtype=torch.int64) & _MASK32
    h = (h + (salt & _MASK32)) & _MASK32
    lo = h * (HASH_MULT & 0xFFFF)
    hi = (h * (HASH_MULT >> 16)) & 0xFFFF
    h = (lo + (hi << 16)) & _MASK32
    h = h ^ (h >> 16)
    return (h % num_partitions).to(torch.int32)


@dataclass(frozen=True)
class PartitionScheme:
    """How a query's execution is split: hash ``var`` into ``num_partitions``."""

    var: str
    num_partitions: int
    salt: int = 0

    def shard_of(self, codes: np.ndarray) -> np.ndarray:
        return hash_partition(codes, self.num_partitions, salt=self.salt)


def _aggregate_degrees(stats, var: str):
    """Summed degree vector of ``var`` over every factor containing it.

    The hash partitions *codes*, so the unit of placement is one code's
    total row mass across the partitioned occurrences — exactly this sum.
    ``None`` when no factor kept a degree vector for ``var`` (domain past
    ``DEGREE_CAP``), in which case skew is unknowable from the stats.
    """
    total = None
    for fs in stats.factor_stats:
        deg = fs.degrees.get(var)
        if deg is None:
            continue
        total = deg.copy() if total is None else total + deg
    return total


def _top_key_share(stats, var: str) -> float:
    """Mass fraction of ``var``'s heaviest code (0.0 when unknown).

    A code is atomic under hash partitioning: whichever shard its heaviest
    code lands on carries at least this fraction of the partitioned work,
    so ``1 / top_key_share`` caps achievable speedup no matter how many
    shards are cut ("Skew Strikes Back": the degree distribution, not the
    cardinality, decides what parallelism buys).
    """
    deg = _aggregate_degrees(stats, var)
    if deg is None:
        return 0.0
    total = float(deg.sum())
    if total <= 0.0:
        return 0.0
    return float(deg.max()) / total


def choose_partition_var(steps: Sequence, order: Sequence[str],
                         stats=None, partitions: int = 1) -> str:
    """Partition key: the costliest step, discounted by key skew.

    Base rule (and the whole rule when ``stats`` is absent): the variable
    of the costliest estimated step — partitioning on a step's eliminated
    variable shards that step and everything downstream of it in the
    message-flow DAG.

    With ``stats``, each candidate's product mass is discounted by how
    much of it is *unparallelizable*: a variable whose heaviest code holds
    share ``s`` of its row mass cannot spread below ``max(s, 1/k)`` on one
    shard, so the shardable benefit is ``product_entries * (1 - cap)``.
    A huge step on a one-hot-key variable (cap -> 1) loses to a slightly
    smaller step that actually splits.  Ties (including the balanced case
    where every cap is 1/k) break toward higher raw product then earlier
    step, which degenerates to the base rule.
    """
    best = None
    best_score = None
    for pos, s in enumerate(steps):
        if stats is not None and partitions > 1:
            cap = max(_top_key_share(stats, s.var), 1.0 / partitions)
            score = (s.product_entries * (1.0 - cap), s.product_entries,
                     -pos)
        else:
            score = (s.product_entries, -pos)
        if best_score is None or score > best_score:
            best, best_score = s, score
    if best is not None:
        return best.var
    if not order:
        raise ValueError("cannot choose a partition variable: empty order")
    return order[-1]


def fold_loads(sizes: Sequence[float], workers: int) -> np.ndarray:
    """Greedy largest-first (LPT) fold of shard loads onto ``workers`` bins.

    Models what a work-stealing pool does with over-partitioned shards:
    big shards land first, small ones fill the valleys.  Used both to
    *predict* folded balance (:func:`choose_partition_fold`) and to
    *report* it (the executor's ``shard_report`` skew is computed over
    these per-worker loads, so fold=1 degenerates to per-shard skew).
    """
    workers = max(1, int(workers))
    loads = np.zeros(workers, np.float64)
    for s in sorted((float(s) for s in sizes), reverse=True):
        loads[int(np.argmin(loads))] += s
    return loads


def choose_partition_fold(stats, var: str, partitions: int, *,
                          max_fold: int = 8, target_skew: float = 1.2,
                          salt: int = 0) -> int:
    """Over-partitioning factor ``f``: cut ``partitions * f`` virtual
    shards so folding can smooth hash unluck.

    With exactly ``k`` shards, one hot code landing next to a merely warm
    one doubles that shard; with ``k*f`` virtual shards folded back onto
    ``k`` workers, the fold redistributes everything *except* the atomic
    hot codes.  Simulates the real ``hash_partition`` on ``var``'s
    aggregate degree vector and picks the smallest ``f`` whose predicted
    folded worker skew (max/mean) meets ``target_skew``; if none does
    (e.g. a single code holds half the mass), the best-predicted ``f``
    wins.  Returns 1 when no degree vector exists or shards are already
    balanced — over-partitioning is pure overhead then.
    """
    partitions = max(1, int(partitions))
    if partitions == 1:
        return 1
    deg = None if stats is None else _aggregate_degrees(stats, var)
    if deg is None or float(deg.sum()) <= 0.0:
        return 1
    codes = np.arange(len(deg))
    best_f, best_skew = 1, np.inf
    f = 1
    while f <= max_fold:
        pids = hash_partition(codes, partitions * f, salt=salt)
        shard_loads = np.bincount(pids, weights=deg,
                                  minlength=partitions * f)
        worker = fold_loads(shard_loads, partitions)
        mean = float(worker.mean())
        skew = float(worker.max()) / mean if mean > 0 else 1.0
        if skew < best_skew - 1e-12:
            best_f, best_skew = f, skew
        if skew <= target_skew:
            return f
        f *= 2
    return best_f


def partition_encoded(enc: EncodedQuery,
                      scheme: PartitionScheme) -> List[EncodedQuery]:
    """Split an encoded query into per-shard encoded queries.

    Occurrences containing the partition variable are masked to the
    shard's hash slice (a copy of the surviving rows); occurrences without
    it share the original arrays — replication is by reference, never a
    data copy.  Domains are shared globally so codes (and therefore level
    structure and decode) agree across shards.
    """
    if scheme.var not in enc.domains:
        raise ValueError(
            f"partition variable {scheme.var!r} is not a query variable "
            f"(have: {sorted(enc.domains)})")
    with _span("dist:partition_encoded", cat="dist", var=scheme.var,
               partitions=scheme.num_partitions):
        occ_pids = [scheme.shard_of(cols[scheme.var]) if scheme.var in cols
                    else None for cols in enc.encoded_tables]
        out: List[EncodedQuery] = []
        for s in range(scheme.num_partitions):
            tabs = []
            for cols, pids in zip(enc.encoded_tables, occ_pids):
                if pids is None:
                    tabs.append(cols)                # replicated by reference
                else:
                    m = pids == s
                    tabs.append({v: a[m] for v, a in cols.items()})
            out.append(EncodedQuery(enc.query, enc.domains, tabs))
        return out


def partition_counts(enc: EncodedQuery, scheme: PartitionScheme) -> np.ndarray:
    """Rows per shard across the partitioned occurrences (balance probe).

    The numpy view of :func:`partition_histogram`; benchmarks and the
    executor's observability use it to report hash balance under skew.
    """
    counts = np.zeros(scheme.num_partitions, INT)
    for cols in enc.encoded_tables:
        if scheme.var in cols:
            counts += np.bincount(scheme.shard_of(cols[scheme.var]),
                                  minlength=scheme.num_partitions)
    return counts


# ---------------------------------------------------------------------------
# Device primitives (one torch device; with a mesh, one rank's slice of
# the codes on each rank's device, summed over a mesh axis).
# ---------------------------------------------------------------------------

def partition_histogram(codes, num_partitions: int, *, salt: int = 0,
                        device: Union[str, torch.device] = "cuda",
                        mesh=None, axis: str = "data") -> torch.Tensor:
    """Per-partition row counts of a code column, on ``device``.

    Hash on the device, then histogram the partition ids with
    :func:`sharded_potential_counts` (over ``mesh``'s ``axis`` when given,
    ``codes`` then this rank's slice).  Matches
    ``np.bincount(hash_partition(codes, k))`` of the whole column exactly.
    """
    return sharded_potential_counts(
        hash_partition_device(codes, num_partitions, salt=salt,
                              device=device),
        num_partitions, device=device, mesh=mesh, axis=axis)


def sharded_potential_counts(codes, num_codes: int, *,
                             device: Union[str, torch.device] = "cuda",
                             mesh=None, axis: str = "data") -> torch.Tensor:
    """GROUP BY count of dense codes, int64 on ``device``.

    The quantitative-learning histogram of one encoded column, equal to
    ``np.bincount(codes, minlength=num_codes)``; codes past ``num_codes``
    are dropped, as the reference's dead padding slot drops them.  With a
    ``mesh``, ``codes`` are this rank's slice, and the result is the
    all-reduce SUM of every rank's counts over ``axis``'s process group:
    the histogram of the whole column, on every rank.
    """
    dev = engine.resolve_device(device)
    t = torch.as_tensor(codes).to(device=dev, dtype=torch.int64)
    hist = torch.bincount(t, minlength=num_codes)[:num_codes]
    if mesh is not None:
        dist.all_reduce(hist, group=mesh.get_group(axis))
    return hist


# ---------------------------------------------------------------------------
# Parallel desummarization (host threads; numpy releases are best-effort).
# ---------------------------------------------------------------------------

def parallel_desummarize(
    summary: Union[GFJS, ShardedGFJS], num_shards: int, *,
    decode: bool = False
) -> Dict[str, np.ndarray]:
    """Desummarize via concurrent workers; results concatenate in order.

    * :class:`GFJS` — range-sharded: run boundaries are prefix sums, so
      each worker expands its own contiguous row slice
      (``desummarize_range``), the absorbed ``host_parallel_desummarize``
      path of the retired ``dist/gj_parallel.py``;
    * :class:`ShardedGFJS` — one worker per hash shard (the shards are
      already independent summaries), output in shard order, equal to
      :func:`repro_torch.core.gfjs.desummarize` on the same object.
    """
    if isinstance(summary, ShardedGFJS):
        workers = max(1, min(num_shards, len(summary.shards)))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            parts = list(ex.map(
                lambda s: desummarize(s, decode=decode), summary.shards))
        return {v: np.concatenate([p[v] for p in parts])
                for v in summary.column_order}
    total = summary.join_size
    num_shards = max(1, min(num_shards, max(total, 1)))
    step = -(-max(total, 1) // num_shards)
    ranges = [(lo, min(lo + step, total)) for lo in range(0, total, step)]
    if not ranges:
        return desummarize_range(summary, 0, 0, decode=decode)
    with ThreadPoolExecutor(max_workers=num_shards) as ex:
        parts = list(ex.map(
            lambda r: desummarize_range(summary, r[0], r[1], decode=decode),
            ranges))
    return {v: np.concatenate([p[v] for p in parts])
            for v in summary.column_order}
