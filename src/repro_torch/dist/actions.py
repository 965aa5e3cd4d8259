"""Shard-build action protocol + process-pool shard executor (DESIGN §17).

Sharded elimination scales at the step level (each shard's products are
~1/k of the monolithic ones), but the thread-pooled build in
``Executor._summarize_partitioned`` serializes numpy pipelines on the
GIL.  This module promotes shards to real processes with an ARMI-style
action protocol: the coordinator broadcasts self-describing work units, the
workers answer with self-describing results, and nothing else crosses the
boundary.

Wire format (both directions reuse the ``core/storage.py`` codec):

* **action** (:class:`ShardBuildAction` → :func:`encode_action`): a
  ``GJSB``-magic container — JSON header (shard id, elimination order,
  plan knobs, step estimates) + the shard's serialized
  :class:`~repro_torch.relational.encoding.EncodedQuery` slice
  (``encoded_query_to_bytes``).
* **result** (:class:`ShardBuildResult` → :func:`encode_result`): a
  ``GJSB``-magic container — JSON header (join size, per-step measured
  products/seconds, worker wall, serialized span records, metrics
  snapshot) + the shard's GFJS blob (``gfjs_to_bytes``).

Workers run the full per-shard pipeline — ``build_generator`` +
``generate_gfjs`` (or the torch frontier when the action pins it) — inside
a root ``shard:<i>`` span on a private tracer; the coordinator grafts the
returned span records under its ``phase:summarize`` span and merges the
metrics snapshot, so ``explain(analyze=True)`` and the shard report look
the same whether shards ran on threads or processes.

:class:`ProcessShardExecutor` owns a **persistent** spawn-based
``ProcessPoolExecutor`` (spawn, not fork: CUDA state does not survive
forking, and spawn workers import a clean interpreter).  Fault posture: a
worker that dies (``BrokenProcessPool``), times out, or raises is retried
**once inline on the coordinator thread** — the thread path is the last
resort, so a crashed shard degrades the query to partially-threaded
execution instead of killing it.  Timeouts recycle the pool (terminating
its processes) so a hung worker can never wedge the next query.

Port of ``src/repro/dist/actions.py``: the same wire format (a numpy
action encodes to the same bytes in both packages), pool and retry.  The
action's ``"torch"`` backend generates with ``core/engine.py`` on the card
(and raises without one); the executor never sends one to the pool, so
workers generate on numpy and never open a CUDA context.  The fault hook
reads its own variable, :data:`FAULT_ENV`, so the reference's hook never
faults the port's workers.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.gfjs import GFJS
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import Tracer
from repro_torch.relational.encoding import EncodedQuery

ACTION_MAGIC = b"GJSB"
ACTION_VERSION = 1
KIND_ACTION = "shard_build"
KIND_RESULT = "shard_build_result"

#: Set by the pool initializer in worker processes only.  Fault hooks
#: (test-only) and the worker-side registry reset are gated on it, so the
#: inline thread-path retry of a faulted action never re-faults (or wipes
#: the coordinator's metrics).
_IN_WORKER = False

#: Env hook for fault-injection tests: ``"kill:<shard>"`` hard-exits the
#: worker mid-build, ``"hang:<shard>:<seconds>"`` sleeps past any timeout.
#: Read only in worker processes (spawn inherits the coordinator environ).
FAULT_ENV = "REPRO_TORCH_SHARD_FAULT"


@dataclass
class ShardBuildAction:
    """One self-describing unit of shard work.

    Everything the worker needs and nothing it must look up: the encoded
    shard slice plus the plan knobs that pin how to build it.  ``fault``
    is the in-band test hook (same contract as :data:`FAULT_ENV`).
    """

    shard: int
    enc: EncodedQuery
    order: Tuple[str, ...]
    early_projection: bool = True
    backend: str = "numpy"                 # GFJS generation engine
    step_estimates: Dict[str, float] = field(default_factory=dict)
    fault: Optional[str] = None


@dataclass
class ShardBuildResult:
    """A worker's reply: the shard summary + every measurement it took."""

    shard: int
    gfjs: GFJS
    join_size: int
    step_products: Dict[str, float]
    step_seconds: Dict[str, float]
    build_seconds: float                   # worker-side pipeline wall
    spans: List[Dict[str, Any]] = field(default_factory=list)
    metrics: Dict[str, Dict[str, Any]] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Wire format — header JSON + one storage-codec payload blob.
# ---------------------------------------------------------------------------

def _pack(kind: str, header: Dict[str, Any], payload: bytes) -> bytes:
    header = dict(header)
    header["kind"] = kind
    hjson = json.dumps(header).encode()
    return (ACTION_MAGIC + struct.pack("<HH", ACTION_VERSION, 0)
            + struct.pack("<Q", len(hjson)) + hjson + payload)


def _unpack(data: bytes, kind: str) -> Tuple[Dict[str, Any], bytes]:
    if data[:4] != ACTION_MAGIC:
        raise ValueError("not a shard-action container (bad magic)")
    (version, _flags) = struct.unpack("<HH", data[4:8])
    if version != ACTION_VERSION:
        raise ValueError(f"unsupported shard-action version {version}")
    (hlen,) = struct.unpack("<Q", data[8:16])
    header = json.loads(data[16:16 + hlen])
    if header.get("kind") != kind:
        raise ValueError(
            f"expected a {kind!r} container, got {header.get('kind')!r}")
    return header, data[16 + hlen:]


def encode_action(action: ShardBuildAction, *,
                  codec: Optional[str] = None) -> bytes:
    from repro_torch.core.storage import encoded_query_to_bytes
    header = {
        "shard": int(action.shard),
        "order": list(action.order),
        "early_projection": bool(action.early_projection),
        "backend": action.backend,
        "step_estimates": {k: float(v)
                           for k, v in action.step_estimates.items()},
        "fault": action.fault,
    }
    return _pack(KIND_ACTION, header,
                 encoded_query_to_bytes(action.enc, codec=codec))


def decode_action(data: bytes) -> ShardBuildAction:
    from repro_torch.core.storage import encoded_query_from_bytes
    header, payload = _unpack(data, KIND_ACTION)
    return ShardBuildAction(
        shard=int(header["shard"]),
        enc=encoded_query_from_bytes(payload),
        order=tuple(header["order"]),
        early_projection=bool(header["early_projection"]),
        backend=header.get("backend", "numpy"),
        step_estimates=dict(header.get("step_estimates", {})),
        fault=header.get("fault"),
    )


def encode_result(result: ShardBuildResult, *,
                  codec: Optional[str] = None) -> bytes:
    from repro_torch.core.storage import gfjs_to_bytes
    header = {
        "shard": int(result.shard),
        "join_size": int(result.join_size),
        "step_products": {k: float(v)
                          for k, v in result.step_products.items()},
        "step_seconds": {k: float(v)
                         for k, v in result.step_seconds.items()},
        "build_seconds": float(result.build_seconds),
        "spans": result.spans,
        "metrics": result.metrics,
    }
    return _pack(KIND_RESULT, header, gfjs_to_bytes(result.gfjs, codec=codec))


def decode_result(data: bytes) -> ShardBuildResult:
    from repro_torch.core.storage import gfjs_from_bytes
    header, payload = _unpack(data, KIND_RESULT)
    return ShardBuildResult(
        shard=int(header["shard"]),
        gfjs=gfjs_from_bytes(payload),
        join_size=int(header["join_size"]),
        step_products=dict(header["step_products"]),
        step_seconds=dict(header["step_seconds"]),
        build_seconds=float(header["build_seconds"]),
        spans=list(header.get("spans", [])),
        metrics=dict(header.get("metrics", {})),
    )


# ---------------------------------------------------------------------------
# Worker side.
# ---------------------------------------------------------------------------

def _worker_init(parent_sys_path: List[str]) -> None:
    """Runs in each spawned worker before any action.

    Adopts the coordinator's ``sys.path`` (spawn children only inherit the
    environment, not in-process path edits) and marks the process as a
    worker so fault hooks and the registry reset become live.
    """
    global _IN_WORKER
    _IN_WORKER = True
    for p in parent_sys_path:
        if p not in sys.path:
            sys.path.append(p)


def _maybe_fault(action: ShardBuildAction) -> None:
    """Honor in-band / env fault hooks — worker processes only."""
    if not _IN_WORKER:
        return
    faults = [action.fault, os.environ.get(FAULT_ENV)]
    for spec in faults:
        if not spec:
            continue
        parts = spec.split(":")
        mode = parts[0]
        target = int(parts[1]) if len(parts) > 1 and parts[1] else None
        if target is not None and target != action.shard:
            continue
        if mode == "kill":
            os._exit(13)
        if mode == "hang":
            time.sleep(float(parts[2]) if len(parts) > 2 else 3600.0)
        if mode == "raise":
            raise RuntimeError(f"injected fault on shard {action.shard}")


def perform_action(action: ShardBuildAction) -> ShardBuildResult:
    """Run the full per-shard pipeline for one action, in this process.

    Spans land on a private tracer under a root ``shard:<i>`` span and are
    returned as records; in a worker process the process-global metrics
    registry is reset first so the snapshot in the result is exactly this
    action's metrics (workers are dedicated to shard actions).  On the
    inline thread-path retry neither happens to the coordinator's state:
    metrics flow into the live registry as on the normal thread path, and
    the snapshot stays empty (nothing to merge — no double counting).
    """
    from repro_torch.core.elimination import build_generator
    from repro_torch.core.gfjs import generate_gfjs
    _maybe_fault(action)
    if _IN_WORKER:
        REGISTRY.reset()
    tracer = Tracer()
    t0 = time.perf_counter()
    with tracer.span(f"shard:{action.shard}", cat="shard",
                     shard=action.shard) as sp:
        gen = build_generator(
            action.enc,
            elimination_order=list(action.order),
            early_projection=action.early_projection,
            step_estimates=dict(action.step_estimates) or None,
        )
        if action.backend == "torch":
            from repro_torch.core.engine import generate_gfjs as generate_torch
            gfjs = generate_torch(gen, action.enc.domains, device="cuda")
        else:
            gfjs = generate_gfjs(gen, action.enc.domains)
        sp.set(rows=gfjs.join_size)
    build_seconds = time.perf_counter() - t0
    return ShardBuildResult(
        shard=action.shard,
        gfjs=gfjs,
        join_size=int(gfjs.join_size),
        step_products={k: float(v) for k, v in gen.step_products.items()},
        step_seconds=dict(gen.step_seconds),
        build_seconds=build_seconds,
        spans=tracer.records(),
        metrics=REGISTRY.snapshot() if _IN_WORKER else {},
    )


def run_shard_action(payload: bytes) -> bytes:
    """The pool's target: bytes in, bytes out (fully self-describing)."""
    return encode_result(perform_action(decode_action(payload)))


# ---------------------------------------------------------------------------
# Coordinator side — the persistent process pool.
# ---------------------------------------------------------------------------

@dataclass
class DispatchOutcome:
    """One action's result + how it got there."""

    result: ShardBuildResult
    t_done: float                  # coordinator perf_counter at completion
    retried: bool = False          # process attempt failed, thread saved it
    error: Optional[str] = None    # the process-side failure, if any


class ProcessShardExecutor:
    """Persistent spawn-pool that runs :class:`ShardBuildAction` batches.

    ``timeout`` (seconds, per action) bounds how long the coordinator
    waits for any single worker reply; a timed-out or crashed action is
    retried once inline (thread path) and the pool is recycled so the
    stuck process cannot absorb a worker slot forever.
    """

    def __init__(self, max_workers: int, *,
                 timeout: Optional[float] = None) -> None:
        self.max_workers = max(1, int(max_workers))
        self.timeout = timeout
        self._pool = None

    # -- pool lifecycle ----------------------------------------------------
    def _ensure_pool(self):
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            self._pool = ProcessPoolExecutor(
                max_workers=self.max_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(list(sys.path),),
            )
        return self._pool

    def _recycle(self) -> None:
        """Tear the pool down hard (used after a timeout/crash): terminate
        worker processes so a hung action cannot wedge the next batch."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        try:
            for p in list(getattr(pool, "_processes", {}).values()):
                p.terminate()
        except Exception:
            pass
        try:
            pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    # -- dispatch ----------------------------------------------------------
    def run(self, actions: Sequence[ShardBuildAction], *,
            timeout: Optional[float] = None) -> List[DispatchOutcome]:
        """Dispatch a batch; returns one outcome per action, in order.

        All actions are submitted up front — with ``k`` workers and
        ``k*f`` (over-partitioned) actions, free workers pull the next
        queued action, which is the greedy load-balancing the round-robin
        fold assignment approximates.  Failures degrade per-action: the
        failed action re-runs inline on this thread while the surviving
        futures keep their results.
        """
        timeout = self.timeout if timeout is None else timeout
        payloads = [encode_action(a) for a in actions]
        try:
            pool = self._ensure_pool()
            futures = [pool.submit(run_shard_action, p) for p in payloads]
        except Exception as exc:           # pool would not even start
            return [self._retry_inline(a, str(exc)) for a in actions]
        outcomes: List[Optional[DispatchOutcome]] = [None] * len(actions)
        broken = False
        for i, (action, fut) in enumerate(zip(actions, futures)):
            try:
                data = fut.result(timeout=timeout)
                outcomes[i] = DispatchOutcome(
                    result=decode_result(data), t_done=time.perf_counter())
            except (BrokenProcessPool, FutureTimeoutError,
                    Exception) as exc:  # noqa: B014 - deliberate catch-all
                broken = True
                outcomes[i] = self._retry_inline(action, repr(exc))
        if broken:
            # a timed-out worker is still running (or the pool is already
            # broken): recycle so the next batch starts from clean slots
            self._recycle()
        return [o for o in outcomes if o is not None]

    def _retry_inline(self, action: ShardBuildAction,
                      error: str) -> DispatchOutcome:
        """The last-resort thread path: run the action in-process.

        Goes through the wire codec anyway so inline results are
        indistinguishable from worker results (and the codec stays
        exercised even when every pool attempt fails).
        """
        REGISTRY.counter("dist.shard_retries").inc()
        data = run_shard_action(encode_action(action))
        return DispatchOutcome(result=decode_result(data),
                               t_done=time.perf_counter(),
                               retried=True, error=error)


# Process-wide shared executor: spawn startup takes seconds per worker (each
# imports repro_torch, and so torch), so the pool persists across queries
# (grown, never shrunk, to the largest worker count requested).  Tests call
# :func:`shutdown_shared_executor` to force a fresh pool (e.g. after setting
# the fault env hook).
_SHARED: Optional[ProcessShardExecutor] = None


def shared_shard_executor(max_workers: int) -> ProcessShardExecutor:
    global _SHARED
    if _SHARED is None or _SHARED.max_workers < max_workers:
        if _SHARED is not None:
            _SHARED.shutdown()
        _SHARED = ProcessShardExecutor(max_workers)
    return _SHARED


def shutdown_shared_executor() -> None:
    global _SHARED
    if _SHARED is not None:
        _SHARED.shutdown()
        _SHARED = None
