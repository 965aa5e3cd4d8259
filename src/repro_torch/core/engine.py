"""Torch engine for GJ's two device phases: desummarization and generation.

Port of ``src/repro/core/engine_jax.py`` (``desummarize_jax`` and the
device-resident ``generate_gfjs_jax``).  Both phases rest on one kernel,
the fused RLE expansion ``kernels/expand_many.py`` (CUDA on the card, the
plain PyTorch version for CPU tensors), launched once per GFJS level when
desummarizing and once per psi when generating.

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
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.elimination import Generator, Psi
from repro_torch.core.gfjs import GFJS, LevelSummary
from repro_torch.core.gfjs import generate_gfjs as generate_gfjs_numpy
from repro_torch.core.potentials import INT, pack_keys
from repro_torch.kernels import ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span
from repro_torch.relational.encoding import Domain

I32_MAX = (1 << 31) - 1


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
