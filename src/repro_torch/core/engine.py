"""Torch engine for GJ's device phases.

Port of ``src/repro/core/engine_jax.py``:

* desummarization and device-resident generation (``desummarize_jax``,
  ``generate_gfjs_jax``) rest on the fused RLE expansion
  ``kernels/expand_many.py``, launched once per GFJS level when
  desummarizing and once per psi when generating;
* quantitative learning on the device (``build_factor_jax``): sort ->
  ``kernels/run_boundaries.py`` -> cumsum -> ``kernels/mul_segsum.py``;
* the summary algebra's reductions (``segment_weighted_sum``,
  ``weighted_total``) on ``mul_segsum``, and its device GROUP BY sort
  (``group_runs_device``) on a stable ``torch.sort`` and
  ``run_boundaries``;
* the dense sum-product message (``maybe_dense_message``) on
  ``kernels/dense_message.py``.

Each kernel is CUDA on the card and its plain PyTorch version for CPU
tensors.  Deliberate differences from the reference, each for exactness:

* its Pallas ``mul_segsum`` sums in f32 and is exact only below 2^24; the
  port's kernel accumulates in int64 / float64, so every summary reduction
  takes it and no exactness guard exists;
* its ``maybe_dense_message`` multiplies in f32, so products and row sums
  past 2^24 round although each operand is below 2^24; the port's kernel
  forms 64-bit products of int32 counts and sums them in int64, equal to
  the numpy route (``multiply`` then ``marginalize_out``) bit for bit;
* its generation scans expansion counts in int32 (``jnp.cumsum``), which
  wraps; the port scans in int64.

Every entry point takes an explicit ``device``: ``"cuda"`` (the default)
raises when no card is present, and only ``"cpu"`` runs the plain
versions.  Arrays keep exact sizes — no padding buckets — so the frontier
of the largest level is as big as the level and no bigger.

The reference's int32 envelope is kept: a generator outside it
(:func:`_torch_generable`), a level whose codes pass int32, or (in the
executor) a join size past int32 takes the numpy route the reference takes.
Each such case adds one to the ``engine.numpy_fallbacks`` counter and marks
its span with the reason: a visible capability check, not a hidden one.
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.elimination import Generator, Psi
from repro_torch.core.gfjs import GFJS, LevelSummary, ShardedGFJS
from repro_torch.core.gfjs import generate_gfjs as generate_gfjs_numpy
from repro_torch.core.potentials import INT, Factor, pack_keys
from repro_torch.kernels import ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.obs.trace import span as _span
from repro_torch.relational.encoding import Domain

I32_MAX = (1 << 31) - 1
DENSE_BUDGET = 1 << 22   # max densified cells for the dense message path
F32_EXACT = 1 << 24      # the reference's operand guard on that path
# run counts below this: the host argsort beats device round-trips
GROUP_DEVICE_MIN_RUNS = 1 << 15


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device an entry point runs on; a missing card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available (pass device='cpu' for the plain PyTorch versions)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(have: cuda, cpu)")
    return dev


def count_numpy_fallback(sp, reason: str) -> None:
    """Record one case outside the int32 envelope that ran on numpy."""
    REGISTRY.counter("engine.numpy_fallbacks").inc()
    sp.set(fallback=reason)


def _upload(a: np.ndarray, dtype: np.dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


def _uploads(dev: torch.device, *arrays: Tuple[np.ndarray, np.dtype]
             ) -> List[torch.Tensor]:
    """Host arrays to the device, under one ``engine:upload`` span."""
    with _span("engine:upload", cat="transfer") as sp:
        out = [_upload(a, dt, dev) for a, dt in arrays]
        sp.set(bytes=sum(t.numel() * t.element_size() for t in out))
    return out


def _download(t: torch.Tensor, dtype: Optional[np.dtype] = None
              ) -> np.ndarray:
    """A device result to the host as numpy (of ``dtype`` where given),
    under an ``engine:download`` span (which also waits for the kernels
    that produce it).  A CUDA tensor of at least ``STAGE_BYTES`` goes
    through :func:`_staged`; anything smaller is one pageable copy (a CPU
    tensor: no copy unless ``dtype`` widens it).

    Traced, the span splits into ``engine:download:ready`` (the wait for
    the kernels), ``engine:download:d2h`` (the card's copy) and
    ``engine:download:host`` (the host's copy or widening), each with its
    ``bytes``; untraced, it adds no event, synchronize or clock read."""
    nbytes = t.numel() * t.element_size()
    with _span("engine:download", cat="transfer", bytes=nbytes) as sp:
        traced = sp is not NULL_SPAN
        if t.device.type == "cuda" and nbytes >= STAGE_BYTES:
            return _staged(t.reshape(-1), dtype, traced)
        with _part(traced, "ready", nbytes):
            if traced and t.device.type == "cuda":
                torch.cuda.current_stream(t.device).synchronize()
        with _part(traced, "d2h", nbytes):
            a = t.cpu().numpy()
        if dtype is None or a.dtype == dtype:
            return a
        with _part(traced, "host", nbytes):
            return a.astype(dtype)


def _part(traced: bool, part: str, nbytes: int):
    """``engine:download:<part>`` where the download is traced, else the
    shared no-op (no ambient lookup).  The parts that wait on the card
    are device-annotated."""
    if not traced:
        return NULL_SPAN
    return _span(f"engine:download:{part}", cat="transfer",
                 device=part != "host", bytes=nbytes)


# A large download goes through two pinned buffers of STAGE_BYTES: the
# card copies one chunk while the host moves the chunk before out of the
# other buffer (widening it where asked), split over STAGE_THREADS
# threads.  On the H100's host that takes under half the time of one
# pageable copy (chip_smoke.py times the routes; PERF.md §6).
STAGE_BYTES = 1 << 25
STAGE_THREADS = min(8, os.cpu_count() or 1)


@functools.cache
def _stage_pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(STAGE_THREADS,
                              thread_name_prefix="engine-download")


def _staged(t: torch.Tensor, dtype: Optional[np.dtype],
            traced: bool) -> np.ndarray:
    """A 1-D CUDA tensor to a new numpy array through the staging
    buffers.  They are bytes from torch's caching host allocator, viewed
    as ``t``'s dtype, so every download reuses the same 2 x STAGE_BYTES of
    pinned memory, whatever its dtype.

    ``traced`` records an event before the first chunk's copy and, once
    the first two copies are queued, waits on it under
    ``engine:download:ready``; each chunk's wait for its copy is an
    ``engine:download:d2h`` span and its move out of pinned memory an
    ``engine:download:host`` span."""
    n = t.numel()
    out = np.empty(n, dtype or torch.empty(0, dtype=t.dtype).numpy().dtype)
    chunk = STAGE_BYTES // t.element_size()
    bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8,
                        pin_memory=True).view(t.dtype) for _ in range(2)]
    done = [torch.cuda.Event(), torch.cuda.Event()]
    chunks = -(-n // chunk)
    step = -(-chunk // STAGE_THREADS)
    size = t.element_size()

    def copy_chunk(i: int) -> None:
        lo = i * chunk
        m = min(chunk, n - lo)
        bufs[i % 2][:m].copy_(t[lo:lo + m], non_blocking=True)
        done[i % 2].record()

    with torch.cuda.device(t.device):
        ready = None
        if traced:
            ready = torch.cuda.Event()
            ready.record()
        copy_chunk(0)
        for i in range(chunks):
            if i + 1 < chunks:
                copy_chunk(i + 1)
            if ready is not None:
                with _part(traced, "ready", n * size):
                    ready.synchronize()
                ready = None
            lo = i * chunk
            m = min(chunk, n - lo)
            with _part(traced, "d2h", m * size):
                done[i % 2].synchronize()
            with _part(traced, "host", m * size):
                dst, src = out[lo:lo + m], bufs[i % 2][:m].numpy()
                list(_stage_pool().map(
                    lambda a: np.copyto(dst[a:a + step], src[a:a + step]),
                    range(0, m, step)))
    return out


# ---------------------------------------------------------------------------
# quantitative learning (potential build)
# ---------------------------------------------------------------------------

def build_factor(cols: Dict[str, np.ndarray], sizes: Dict[str, int],
                 *, device: Union[str, torch.device] = "cuda") -> Factor:
    """GROUP BY count on the device: pack -> sort -> ``group_by_count``
    (run_boundaries -> cumsum -> mul_segsum).  Equal to
    ``Factor.from_columns``.

    Keys are packed on the host, as in the reference; a key space whose
    packed ranks pass int32 takes ``Factor.from_columns`` instead, counted
    in ``engine.numpy_fallbacks``.  Counts are int64.
    """
    dev = resolve_device(device)
    names = tuple(cols.keys())
    keys = np.stack([np.asarray(cols[v], dtype=INT) for v in names], axis=1)
    sz = tuple(int(sizes[v]) for v in names)
    n = keys.shape[0]
    if n == 0:
        return Factor(names, keys, np.zeros(0, INT), np.zeros(0, INT), sz)
    with _span("engine:build_factor", cat="build", backend="torch",
               device=True, rows=n) as sp:
        try:
            packed = pack_keys(keys, sz)
            packable = bool(np.all(packed <= I32_MAX))
        except OverflowError:
            packable = False
        if not packable:
            count_numpy_fallback(sp, "packed keys past int32")
            return Factor.from_columns(cols, sizes)
        (packed_t,) = _uploads(dev, (packed, np.int32))
        sorted_keys = torch.sort(packed_t).values
        del packed_t
        _, counts, num = ops.group_by_count(sorted_keys)
        # unique packed keys = sorted keys at the group ends
        upacked = _download(sorted_keys[torch.cumsum(counts, 0) - 1])
        counts = _download(counts)
    ukeys = np.empty((num, len(names)), dtype=INT)
    rem = upacked.astype(INT)
    for j in range(len(names) - 1, -1, -1):
        s = max(sz[j], 1)
        ukeys[:, j] = rem % s
        rem = rem // s
    return Factor(names, ukeys, counts.astype(INT), np.ones(num, INT), sz)


# ---------------------------------------------------------------------------
# message passing (sum-product contraction)
# ---------------------------------------------------------------------------

def dense_inputs(phi: Factor, child: str, msg_vals: np.ndarray):
    """The host half of :func:`maybe_dense_message`: ``None`` where the
    reference declines, else ``(P, V, flat cell index int64, cell values
    int32, message int32)``."""
    if len(phi.vars) != 2 or child not in phi.vars:
        return None
    ci = phi.var_index(child)
    pi = 1 - ci
    P, V = phi.sizes[pi], phi.sizes[ci]
    if P * V > DENSE_BUDGET:
        return None
    vals = phi.bucket * phi.fac
    msg = np.asarray(msg_vals)
    if vals.max(initial=0) >= F32_EXACT or msg.max(initial=0) >= F32_EXACT:
        return None
    if msg.dtype.kind not in "iub" or msg.shape != (V,):
        raise ValueError(f"message must be [{V}] integers, got "
                         f"{msg.dtype} {msg.shape}")
    if vals.min(initial=0) < -I32_MAX - 1 or msg.min(initial=0) < -I32_MAX - 1:
        raise ValueError("counts below -2^31 do not fit the int32 kernel")
    flat = phi.keys[:, pi] * V + phi.keys[:, ci]
    return (P, V, flat, vals.astype(np.int32), msg.astype(np.int32))


def densify(P: int, V: int, flat: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """The int32 ``[P, V]`` potential from its COO cells, on their device
    (cells are unique in a Factor, so each is assigned once)."""
    dense = torch.zeros(P * V, dtype=torch.int32, device=vals.device)
    dense.index_put_((flat,), vals)
    return dense.view(P, V)


def maybe_dense_message(
    phi: Factor, child: str, msg_vals: np.ndarray,
    *, device: Union[str, torch.device] = "cuda",
) -> Optional[np.ndarray]:
    """Dense route for the message ``m_out[p] = sum_v phi[p, v] * m_in[v]``.

    Returns the per-parent-code sums (int64 numpy), or ``None`` where the
    reference declines, and only there: ``phi`` is not over two variables,
    ``child`` is not one of them, ``P * V > DENSE_BUDGET``, or a cell value
    or message reaches 2^24.  Otherwise ``bucket * fac`` is densified into
    an int32 ``[P, V]`` on the device and the counts instantiation of the
    ``dense_message`` kernel contracts it with the message as ``[V, 1]``.

    Unlike the reference (f32 on the MXU, whose products and row sums past
    2^24 round although each operand is below 2^24), the product is exact:
    64-bit products summed in int64, equal to ``phi.multiply(message)
    .marginalize_out(child)`` bit for bit, even where int64 wraps.  A count
    below -2^31 does not fit the kernel's int32 inputs and raises.
    """
    dev = resolve_device(device)
    host = dense_inputs(phi, child, msg_vals)
    if host is None:
        return None
    P, V, flat, vals, msg = host
    with _span("engine:dense_message", cat="message", backend="torch",
               device=True, p=P, v=V, cells=len(vals)):
        flat_t, vals_t, msg_t = _uploads(dev, (flat, np.int64),
                                         (vals, np.int32), (msg, np.int32))
        dense = densify(P, V, flat_t, vals_t)
        out = ops.dense_message(dense, msg_t.view(V, 1))
        return _download(out)[:, 0].astype(INT)


# ---------------------------------------------------------------------------
# summary-side reductions (repro_torch.summary.algebra's hot loop)
# ---------------------------------------------------------------------------

def segment_weighted_sum(
    seg_ids: np.ndarray, values: np.ndarray, weights: np.ndarray,
    num_segments: int, *, device: Union[str, torch.device] = "cuda",
    bound: Optional[float] = None,
) -> np.ndarray:
    """Per-segment sum of values*weights over sorted dense segment ids.

    The dispatch point for every summary-side aggregate: all traffic,
    integer and float, rides the ``mul_segsum`` kernel (int64 sums for
    integers, float64 for floats).  ``bound`` is the reference's hint for
    skipping its f32-exactness scan; the port's kernel has no f32 ceiling,
    so it is accepted and not needed.  Returns numpy, as the reference.
    """
    del bound
    dev = resolve_device(device)
    values = np.asarray(values)
    weights = np.asarray(weights)
    floaty = values.dtype.kind == "f" or weights.dtype.kind == "f"
    if len(values) == 0:
        return np.zeros(num_segments, np.float64 if floaty else np.int64)
    acc = np.float64 if floaty else np.int64
    seg_t, x, w = _uploads(dev, (seg_ids, np.int32), (values, acc),
                           (weights, acc))
    out = _download(ops.mul_segsum(seg_t, x, w, num_segments))
    return out if floaty else out.astype(INT)


def weighted_total(
    values: np.ndarray, weights: np.ndarray,
    *, device: Union[str, torch.device] = "cuda",
    bound: Optional[float] = None,
):
    """sum(values * weights) — a one-segment reduction."""
    seg = np.zeros(len(np.asarray(values)), np.int32)
    out = segment_weighted_sum(seg, values, weights, 1, device=device,
                               bound=bound)
    return out[0] if len(out) else out.dtype.type(0)


def group_device_enabled(device: Union[str, torch.device]) -> bool:
    """Route group_by sorts to the device only for a CUDA device: on the
    CPU the host argsort does the same work without the copies."""
    return torch.device(device).type == "cuda"


def group_runs_device(
    ranks: np.ndarray, *, device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Grouped-run decomposition via a device packed-key sort.

    Input: packed int64 ranks (one per live run).  Output matches the host
    ``group_ranks``: (stable sort order, dense int32 segment ids, group
    starts, group count).  The sort is a stable ``torch.sort`` (the
    reference's is ``jnp.argsort``, outside any kernel); the run
    boundaries are the ``run_boundaries`` kernel over int64 keys.
    """
    dev = resolve_device(device)
    n = len(ranks)
    if n == 0:
        return (np.zeros(0, INT), np.zeros(0, np.int32),
                np.zeros(0, INT), 0)
    with _span("engine:group_runs", cat="summary", backend="torch",
               device=True, runs=n):
        (ranks_t,) = _uploads(dev, (ranks, np.int64))
        sorted_ranks, order = torch.sort(ranks_t, stable=True)
        del ranks_t
        flags = ops.run_boundaries(sorted_ranks)
        seg = torch.cumsum(flags, 0, dtype=torch.int32).sub_(1)
        starts = torch.nonzero(flags).squeeze(1)
        order, seg, starts = _download(order), _download(seg), \
            _download(starts)
    return order.astype(INT), seg, starts.astype(INT), int(len(starts))


# ---------------------------------------------------------------------------
# desummarization
# ---------------------------------------------------------------------------

def desummarize(
    gfjs: GFJS, *, decode: bool = False, device: Union[str, torch.device] = "cuda",
    into: Optional[Dict[str, torch.Tensor]] = None, offset: int = 0,
) -> Dict[str, Union[torch.Tensor, np.ndarray]]:
    """RLE-expand every level with one fused kernel launch per level.

    Each level's launch data (int32 codes and bounds) comes from the
    device memo on the GFJS (``ops.gfjs_launch``): generation fills it, so
    a desummarize after ``run()`` uploads nothing and scans nothing on the
    host; a GFJS without it uploads each level once and keeps it.  An
    identity level (one run per row, every run of length 1) launches
    nothing: its columns are a device copy of its codes.  ``decode=False``
    keeps the codes on ``device``: an int32 tensor of ``join_size`` rows
    per column.  ``decode=True`` copies each column to the host and
    decodes it through the GFJS domains, returning numpy arrays of raw
    values.

    ``into`` (variable -> column on ``device``) receives each column in
    rows ``[offset, offset + join_size)`` instead of a new tensor and is
    returned; ``decode`` must then be False.  :func:`desummarize_sharded`
    writes its shards so.

    A join past the int32 kernel range raises.  A level whose codes pass
    int32 raises on a CUDA device; on the CPU it expands on numpy, is
    counted in ``engine.numpy_fallbacks``, and its columns are int64.
    """
    total = gfjs.join_size
    if total > I32_MAX:
        raise ValueError("join size exceeds the int32 kernel range; "
                         "use range-sharded desummarization")
    if into is not None and decode:
        raise ValueError("decode=True cannot write into device columns")
    dev = resolve_device(device)
    out: Dict[str, Union[torch.Tensor, np.ndarray]] = {}

    def put(v: str, col: torch.Tensor) -> None:
        if into is None:
            out[v] = gfjs.domains[v].decode(col.cpu().numpy()) \
                if decode else col
            return
        if col.dtype == torch.int64 and into[v].dtype != torch.int64:
            into[v] = into[v].to(torch.int64)
        into[v][offset:offset + total].copy_(col)

    for li, lvl in enumerate(gfjs.levels):
        with _span(f"desummarize:level:{li}", cat="gen", backend="torch",
                   device=True, runs=lvl.num_runs) as sp:
            bounds, codes = ops.gfjs_launch(gfjs, li, dev)     # memoized
            if codes is None:
                # codes past the int32 kernel range (domains >= 2**31
                # values): the kernel cannot carry them
                if dev.type == "cuda":
                    raise ValueError(
                        f"level {li} holds codes past the int32 kernel "
                        "range; expand it on the CPU device")
                count_numpy_fallback(sp, "codes past int32")
                for v in lvl.vars:
                    put(v, torch.from_numpy(np.repeat(lvl.key_cols[v],
                                                      lvl.freq)))
                continue
            if bounds is None:
                # the identity level: a copy (``into`` copies too), so
                # that a caller writing into a column cannot change the
                # memo
                sp.set(identity=True)
                cols = codes.clone() if into is None else codes
            else:
                cols = ops.rle_expand_many(codes, bounds, total)
            for k, v in enumerate(lvl.vars):
                put(v, cols[k])
            del cols
    if into is not None:
        return into
    return {v: out[v] for v in gfjs.column_order}


def desummarize_sharded(
    sharded: ShardedGFJS, *, decode: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Union[torch.Tensor, np.ndarray]]:
    """A ``ShardedGFJS``'s rows in shard order, as the reference
    concatenates them: :func:`desummarize` writes each shard into its
    slice of one preallocated column per variable, so at most one level
    of one shard is held beside the result (a concatenation of per-shard
    columns would hold the result twice).  ``decode=False`` keeps the
    codes on ``device``; ``decode=True`` decodes each column on the host.
    A shard past the int32 kernel range raises before anything is
    allocated, as :func:`desummarize` does for such a join.
    """
    if any(s.join_size > I32_MAX for s in sharded.shards):
        raise ValueError("a shard's join size exceeds the int32 kernel "
                         "range; use more partitions")
    dev = resolve_device(device)
    out = {v: torch.empty(sharded.join_size, dtype=torch.int32, device=dev)
           for v in sharded.column_order}
    lo = 0
    for si, shard in enumerate(sharded.shards):
        with _span(f"desummarize:shard:{si}", cat="gen", backend="torch",
                   device=True, rows=shard.join_size):
            desummarize(shard, device=dev, into=out, offset=lo)
        lo += shard.join_size
    if decode:
        return {v: sharded.domains[v].decode(col.cpu().numpy())
                for v, col in out.items()}
    return out


# ---------------------------------------------------------------------------
# device-resident GFJS generation (Algorithms 3/4 on the device)
# ---------------------------------------------------------------------------
#
# The frontier (one int32 column per generated variable, plus the running
# int64 ``p_bucket`` and per-level ``fac_acc``) stays on the device at its
# exact live size.  Group lookup is a packed-key ``torch.searchsorted``
# against each psi's pre-packed parent keys; expansion is ONE fused kernel
# launch per psi that carries every frontier column plus the (src, CSR
# start, offset) index columns.  The host sees one scalar per psi (the new
# frontier size, which sizes the kernel's output) and the per-level arrays
# when a LevelSummary is emitted.


@dataclass
class _DevicePsi:
    """One psi, uploaded once: packed parent keys + CSR arrays."""

    parents: Tuple[str, ...]
    radices: Tuple[int, ...]   # parent domain sizes (packing)
    keys: torch.Tensor         # [g] int64 packed parent keys, ascending
    start: torch.Tensor        # [g] int32 CSR start
    count: torch.Tensor        # [g] int64 CSR count
    child: torch.Tensor        # [m] int32 child codes
    bucket: torch.Tensor       # [m] int64
    fac: torch.Tensor          # [m] int64


def _radix_packable(sizes: Sequence[int]) -> bool:
    total = 1
    for s in sizes:
        total *= max(int(s), 1)
        if total >= (1 << 62):
            return False
    return True


def _torch_generable(gen: Generator) -> bool:
    """Do the int32-kernel / int64-packing preconditions hold?"""
    if gen.join_size > I32_MAX or len(gen.root_codes) > I32_MAX:
        return False
    if len(gen.root_codes) and int(gen.root_codes.max()) > I32_MAX:
        return False
    for level in gen.levels:
        for psi in level:
            if not _radix_packable(psi.parent_sizes):
                return False
            if psi.child_size > I32_MAX or psi.num_entries > I32_MAX \
                    or psi.num_groups > I32_MAX:
                return False
            if any(s > I32_MAX for s in psi.parent_sizes):
                return False
    return True


def _device_psi(psi: Psi, dev: torch.device) -> _DevicePsi:
    """Pack + upload one psi (memoized on the Psi object, per device)."""
    memo = psi.__dict__.setdefault("_uploads", {})
    dp = memo.get(dev)
    if dp is not None:
        return dp
    packed = pack_keys(psi.parent_keys, list(psi.parent_sizes)) \
        if psi.num_groups else np.zeros(0, INT)
    dp = _DevicePsi(
        psi.parents, tuple(int(s) for s in psi.parent_sizes),
        _upload(packed, np.int64, dev), _upload(psi.start, np.int32, dev),
        _upload(psi.count, np.int64, dev),
        _upload(psi.child_codes, np.int32, dev),
        _upload(psi.bucket, np.int64, dev), _upload(psi.fac, np.int64, dev))
    memo[dev] = dp
    return dp


def _frontier_lookup(parent_cols: List[torch.Tensor], n: int,
                     dp: _DevicePsi, dev: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-key group lookup for one psi: (counts int64, CSR start int32).

    A parentless psi packs every row to key 0, matching ``pack_keys`` of a
    zero-width row.  Rows whose key misses psi's parent groups get count 0 —
    exactly the numpy ``_lookup_groups`` miss semantics.
    """
    g = dp.keys.shape[0]
    if g == 0:
        return (torch.zeros(n, dtype=torch.int64, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev))
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    for col, s in zip(parent_cols, dp.radices):
        key.mul_(max(s, 1)).add_(col)
    pos = torch.searchsorted(dp.keys, key).clamp_(max=g - 1)
    hit = dp.keys[pos] == key
    return (torch.where(hit, dp.count[pos], 0),
            torch.where(hit, dp.start[pos], 0))


def _psi_weights(src: torch.Tensor, start: torch.Tensor, offs: torch.Tensor,
                 dp: _DevicePsi, p_bucket: torch.Tensor,
                 fac_acc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recover each output row's psi entry and gather its payloads.

    ``cidx = start[g[src]] + (t - offsets[src])`` — both ingredients were
    expanded by the fused kernel, so this is gathers only (int32 indices,
    in place where it saves device memory).
    """
    cidx = torch.arange(src.shape[0], dtype=torch.int32, device=src.device)
    cidx.sub_(offs).add_(start)
    child = dp.child.index_select(0, cidx)
    pb = p_bucket.index_select(0, src)
    pb.mul_(dp.bucket.index_select(0, cidx))
    fa = fac_acc.index_select(0, src)
    fa.mul_(dp.fac.index_select(0, cidx))
    return child, pb, fa


def expand_level(
    cols: Dict[str, torch.Tensor], p_bucket: torch.Tensor,
    level: Sequence[Psi], n: int, dev: torch.device,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor,
           Tuple[str, ...], int]:
    """Device-resident ``expand_level``: one fused kernel launch per psi.

    Returns ``(cols, p_bucket, freq, new_vars, n_new)``.  The only host
    syncs are the per-psi frontier totals.
    """
    fac_acc = torch.ones_like(p_bucket)
    new_vars: List[str] = []
    for psi in level:
        dp = _device_psi(psi, dev)
        counts, start_g = _frontier_lookup(
            [cols[p] for p in dp.parents], n, dp, dev)
        # int64 scan: the reference's int32 cumsum would wrap silently
        bounds = torch.cumsum(counts, 0)
        total = int(bounds[-1]) if n else 0     # host sync: one per psi
        if total > I32_MAX:
            # every frontier row extends to at least one join row, so the
            # frontier never outgrows join_size, which the envelope bounds
            raise OverflowError(f"frontier of {total} rows at {psi.child!r} "
                                "exceeds the int32 kernel range")
        names = list(cols)
        payloads = torch.stack(
            [cols[v] for v in names]
            + [torch.arange(n, dtype=torch.int32, device=dev), start_g,
               (bounds - counts).to(torch.int32)])
        expanded = ops.rle_expand_many(payloads, bounds.to(torch.int32),
                                       total)
        del payloads, counts, start_g, bounds
        child, p_bucket, fac_acc = _psi_weights(
            expanded[-3], expanded[-2], expanded[-1], dp, p_bucket, fac_acc)
        cols = {v: expanded[i] for i, v in enumerate(names)}
        cols[psi.child] = child
        new_vars.append(psi.child)
        n = total
    return cols, p_bucket, p_bucket * fac_acc, tuple(new_vars), n


def generate_gfjs(
    gen: Generator, domains: Dict[str, Domain],
    *, device: Union[str, torch.device] = "cuda",
) -> GFJS:
    """Device-resident Algorithms 3/4; numpy outside the int32 envelope.

    Level-for-level identical to :func:`repro_torch.core.gfjs.generate_gfjs`
    (expansion is order-preserving in both engines).  Each level's int32
    codes and launch metadata (``ops.level_meta``) stay on the device in
    the returned GFJS's memo (``GFJS._launch``), so that ``desummarize``
    uploads nothing.  Each generated level's host arrays are a deferred
    mirror of that memo (:func:`_mirror_fetch`): nothing is downloaded
    here, and the first host read of a level downloads it once, under
    ``engine:download`` spans, counted in ``engine.mirror_fetches``.
    """
    dev = resolve_device(device)
    if not _torch_generable(gen):
        with _span("gfjs:generate", cat="gen", backend="numpy") as sp:
            count_numpy_fallback(sp, "generator outside the int32 envelope")
            return generate_gfjs_numpy(gen, domains)

    levels_out: List[LevelSummary] = [
        LevelSummary((gen.root,), {gen.root: gen.root_codes}, gen.root_freq)]
    n = len(gen.root_codes)
    cols: Dict[str, torch.Tensor] = {
        gen.root: _upload(gen.root_codes, np.int32, dev)}
    launch: Dict[int, tuple] = {}
    ops.memoize_level(launch, 0, dev, ops.level_meta(
        _upload(gen.root_freq, np.int64, dev), gen.join_size),
        cols[gen.root][None])
    p_bucket = torch.ones(n, dtype=torch.int64, device=dev)

    runs_hist = REGISTRY.histogram("gfjs.runs_per_level", unit="runs")
    runs_hist.observe(n)
    for depth, level in enumerate(gen.levels):
        with _span(f"gfjs:level:{depth}", cat="gen", backend="torch",
                   device=True, depth=depth) as sp:
            cols, p_bucket, freq, new_vars, n = expand_level(
                cols, p_bucket, level, n, dev)
            codes = torch.stack([cols[v] for v in new_vars])
            bounds = ops.level_meta(freq, gen.join_size)
            del freq
            sp.set(runs=n, vars=",".join(new_vars), identity=bounds is None)
        runs_hist.observe(n)
        ops.memoize_level(launch, depth + 1, dev, bounds, codes)
        levels_out.append(LevelSummary.deferred(
            new_vars, n, _mirror_fetch(new_vars, codes, bounds, n)))
    return GFJS(levels_out, list(gen.column_order), gen.join_size, domains,
                _launch=launch)


def _mirror_fetch(names: Sequence[str], codes: torch.Tensor,
                  bounds: Optional[torch.Tensor], runs: int):
    """The fetch of a generated level's host arrays from its memo entry:
    the int32 codes, widened to int64 on the host, and the run lengths,
    the first difference of the int32 bounds downloaded (widened on the
    host) and taken on the host, so the read needs no device memory.  An
    identity level's run lengths are ones, made on the host."""
    def fetch() -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        REGISTRY.counter("engine.mirror_fetches").inc()
        key_cols = {v: _download(codes[k], np.int64)
                    for k, v in enumerate(names)}
        if bounds is None:
            return key_cols, np.ones(runs, INT)
        ends = _download(bounds, np.int64)
        freq = np.empty_like(ends)
        freq[:1] = ends[:1]
        np.subtract(ends[1:], ends[:-1], out=freq[1:])
        return key_cols, freq
    return fetch
