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
  ``run_boundaries``.

Each kernel is CUDA on the card and its plain PyTorch version for CPU
tensors.  Unlike the reference, whose Pallas ``mul_segsum`` sums in f32
and is exact only below 2^24, the port's kernel accumulates in int64 /
float64: every summary reduction takes it, and no exactness guard exists.

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

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.elimination import Generator, Psi
from repro_torch.core.gfjs import GFJS, LevelSummary
from repro_torch.core.gfjs import generate_gfjs as generate_gfjs_numpy
from repro_torch.core.potentials import INT, Factor, pack_keys
from repro_torch.kernels import ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span
from repro_torch.relational.encoding import Domain

I32_MAX = (1 << 31) - 1
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


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(INT)


def _uploads(dev: torch.device, *arrays: Tuple[np.ndarray, np.dtype]
             ) -> List[torch.Tensor]:
    """Host arrays to the device, under one ``engine:upload`` span."""
    with _span("engine:upload", cat="transfer") as sp:
        out = [_upload(a, dt, dev) for a, dt in arrays]
        sp.set(bytes=sum(t.numel() * t.element_size() for t in out))
    return out


def _download(t: torch.Tensor) -> np.ndarray:
    """A device result to the host, under an ``engine:download`` span
    (which also waits for the kernels that produce it)."""
    with _span("engine:download", cat="transfer",
               bytes=t.numel() * t.element_size()):
        return t.cpu().numpy()


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
) -> Dict[str, Union[torch.Tensor, np.ndarray]]:
    """RLE-expand every level with one fused kernel launch per level.

    ``decode=False`` keeps the codes on ``device``: an int32 tensor of
    ``join_size`` rows per column (int64 for a level expanded on numpy).
    ``decode=True`` copies each column to the host and decodes it through
    the GFJS domains, returning numpy arrays of raw values.
    """
    dev = resolve_device(device)
    total = gfjs.join_size
    if total > I32_MAX:
        raise ValueError("join size exceeds the int32 kernel range; "
                         "use range-sharded desummarization")
    out: Dict[str, Union[torch.Tensor, np.ndarray]] = {}
    for li, lvl in enumerate(gfjs.levels):
        with _span(f"desummarize:level:{li}", cat="gen", backend="torch",
                   device=True, runs=lvl.num_runs) as sp:
            if any(lvl.key_cols[v].size
                   and int(lvl.key_cols[v].max()) > I32_MAX
                   for v in lvl.vars):
                # codes past the int32 kernel range (domains >= 2**31
                # values): numpy-expand this level instead of wrapping
                count_numpy_fallback(sp, "codes past int32")
                for v in lvl.vars:
                    col = np.repeat(lvl.key_cols[v], lvl.freq)
                    out[v] = gfjs.domains[v].decode(col) if decode \
                        else torch.from_numpy(col).to(dev)
                continue
            payloads = _upload(np.stack([lvl.key_cols[v] for v in lvl.vars]),
                               np.int32, dev)
            bounds = _upload(gfjs.bounds(li), np.int32, dev)
            cols = ops.rle_expand_many(payloads, bounds, total)
            for k, v in enumerate(lvl.vars):
                out[v] = gfjs.domains[v].decode(cols[k].cpu().numpy()) \
                    if decode else cols[k]
    return {v: out[v] for v in gfjs.column_order}


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
    (expansion is order-preserving in both engines).
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
    p_bucket = torch.ones(n, dtype=torch.int64, device=dev)

    runs_hist = REGISTRY.histogram("gfjs.runs_per_level", unit="runs")
    runs_hist.observe(n)
    for depth, level in enumerate(gen.levels):
        with _span(f"gfjs:level:{depth}", cat="gen", backend="torch",
                   device=True, depth=depth) as sp:
            cols, p_bucket, freq, new_vars, n = expand_level(
                cols, p_bucket, level, n, dev)
            sp.set(runs=n, vars=",".join(new_vars))
        runs_hist.observe(n)
        levels_out.append(LevelSummary(
            new_vars, {v: _host(cols[v]) for v in new_vars}, _host(freq)))
        del freq
    return GFJS(levels_out, list(gen.column_order), gen.join_size, domains)
