"""Public wrappers around the port's kernels — what the torch engine calls.

Each call counts a launch in ``kernels.launches`` and opens a
``kernel:<name>`` span, as the reference's ``kernels/ops.py`` does.  No
padding: the CUDA kernels take exact sizes, so the reference's power-of-two
buckets (which only bound a jit cache) have no counterpart here, and no
``next_bucket`` or ``interpret=`` either.  No ``exact=`` switch on
``mul_segsum``: the port's kernel accumulates in int64 / float64, so it is
the exact path.  ``dense_message`` on int32 counts is exact in int64 (the
reference's f32 MXU product is exact only below 2^24).

The launch metadata of an expansion is only the int32 bounds on the
device: the kernel finds each 2,048-output tile's run window itself (two
searches per tile, then a shared-memory scan), so there are no tile starts
to precompute.  ``gfjs_launch`` memoizes a GFJS level's launch data on the
device, its int32 codes beside its bounds, as the reference memoizes its
padded bounds and tile starts; generation fills that memo, so a
desummarize after ``run()`` uploads nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dense_message import \
    dense_message as _dense_message
from repro_torch.kernels.expand_gather import expand_gather
from repro_torch.kernels.expand_many import expand_many
from repro_torch.kernels.mul_segsum import mul_segsum as _mul_segsum
from repro_torch.kernels.run_boundaries import \
    run_boundaries as _run_boundaries
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span


def _launch(kernel: str, **args):
    """Count a kernel call and open a device-annotated span (the ambient
    no-op when tracing is off)."""
    REGISTRY.counter("kernels.launches").inc()
    return _span(f"kernel:{kernel}", cat="kernel", device=True, **args)


I32_MAX = (1 << 31) - 1


def rle_expand(payload: torch.Tensor, bounds: torch.Tensor, total: int,
               meta: torch.Tensor = None) -> torch.Tensor:
    """Expand one payload (int32 or float32) by its RLE: [runs] -> [total].

    ``meta`` is the device bounds from :func:`expand_meta` or
    :func:`gfjs_expand_meta` (the memoized path for levels expanded again);
    when given, it replaces ``bounds``.
    """
    bounds = bounds if meta is None else meta
    with _launch("rle_expand", runs=int(payload.shape[0]), total=int(total),
                 dtype=str(payload.dtype).removeprefix("torch.")):
        return expand_gather(payload, bounds, total)


def expand_indices(bounds: torch.Tensor, total: int) -> torch.Tensor:
    """Source-run index per output position (frontier expansion's ``src``)."""
    payload = torch.arange(bounds.shape[0], dtype=torch.int32,
                           device=bounds.device)
    return rle_expand(payload, bounds, total)


def expand_meta(bounds, device=None) -> torch.Tensor:
    """Launch metadata for expanding by ``bounds``: the int32 bounds,
    contiguous, on ``device`` (by default a tensor's own device, the card
    for an array).  The cast runs where the bounds are, so an upload moves
    4 bytes per run."""
    if isinstance(bounds, torch.Tensor):
        dev = bounds.device if device is None else torch.device(device)
    else:
        bounds = torch.from_numpy(np.asarray(bounds))
        dev = torch.device("cuda" if device is None else device)
    if bounds.numel() and int(bounds[-1]) > I32_MAX:
        raise ValueError(f"bounds reach {int(bounds[-1])}, past the int32 "
                         f"kernel range")
    return bounds.to(torch.int32).to(dev).contiguous()


def level_meta(freq: torch.Tensor, total: int) -> Optional[torch.Tensor]:
    """Launch metadata of one GFJS level from its int64 run lengths, on
    their device: ``None`` for an identity level (``runs == total`` and
    every run of length 1, so the expansion is the codes themselves), else
    the int32 inclusive bounds (an int64 scan, its last value checked
    against the int32 kernel range, then cast).  One device reduction, and
    only where ``runs == total``; one scalar read for the check.
    """
    runs = freq.shape[0]
    if runs == int(total) and bool(torch.all(freq == 1)):
        return None
    bounds = torch.cumsum(freq, 0)
    if runs and int(bounds[-1]) > I32_MAX:
        raise ValueError(f"bounds reach {int(bounds[-1])}, past the int32 "
                         f"kernel range")
    return bounds.to(torch.int32)


def _memo_device(device) -> torch.device:
    """The memo's key: ``cuda`` and ``cuda:<current>`` are one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def memoize_level(memo: dict, level: int, device,
                  bounds: Optional[torch.Tensor],
                  codes: Optional[torch.Tensor]) -> None:
    """Store one level's launch data in a ``GFJS._launch`` dict."""
    memo[level] = (_memo_device(device), (bounds, codes))


def gfjs_launch(gfjs, level: int, device
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One GFJS level's memoized launch data on ``device``: ``(bounds,
    codes)``, the int32 bounds (``None`` for an identity level, see
    :func:`level_meta`) and the int32 codes ``[K, runs]`` of the level's
    variables (``None`` where a code passes int32: that level expands on
    numpy).

    Generation fills the memo (``engine.generate_gfjs``).  A GFJS without
    it (loaded, made on numpy, or rebuilt from its levels) uploads the
    level once, under an ``engine:upload`` span: the codes as int32 after
    a host check of their range, the int64 run lengths as they are, which
    are then scanned and cast on the device.  One entry per level, kept on
    ``GFJS._launch``: another device replaces it, so the memo stays bounded
    and ``GFJS.aux_nbytes`` counts it.
    """
    dev = _memo_device(device)
    hit = gfjs._launch.get(level)
    if hit is not None and hit[0] == dev:
        return hit[1]
    lvl = gfjs.levels[level]
    codes = None
    if not any(lvl.key_cols[v].size and int(lvl.key_cols[v].max()) > I32_MAX
               for v in lvl.vars):
        codes = np.empty((len(lvl.vars), lvl.num_runs), np.int32)
        for k, v in enumerate(lvl.vars):
            codes[k] = lvl.key_cols[v]
    freq = np.ascontiguousarray(lvl.freq, np.int64)
    with _span("engine:upload", cat="transfer",
               bytes=freq.nbytes + (0 if codes is None else codes.nbytes)):
        freq_t = torch.from_numpy(freq).to(dev)
        codes_t = None if codes is None else torch.from_numpy(codes).to(dev)
    bounds = level_meta(freq_t, gfjs.join_size)
    del freq_t
    memoize_level(gfjs._launch, level, dev, bounds, codes_t)
    return bounds, codes_t


def gfjs_expand_meta(gfjs, level: int, device) -> torch.Tensor:
    """The int32 device bounds of one GFJS level, from its memoized launch
    data (:func:`gfjs_launch`, which fills the memo where it is empty).
    An identity level holds no bounds; its bounds ``1..runs`` are made
    here and not kept."""
    bounds, _ = gfjs_launch(gfjs, level, device)
    if bounds is None:
        bounds = torch.arange(1, gfjs.levels[level].num_runs + 1,
                              dtype=torch.int32, device=_memo_device(device))
    return bounds


def rle_expand_many(payloads: torch.Tensor, bounds: torch.Tensor,
                    total: int) -> torch.Tensor:
    """Expand K int32 payload rows sharing one RLE: [K, runs] -> [K, total].

    One fused kernel launch: each 2,048-output tile finds its run window
    once (two searches) and every output's run by a shared-memory scan,
    reused for all K rows (the codes of every variable of a GFJS level, or
    the frontier columns plus the (src, CSR start, offset) index columns of
    one generation step).
    """
    k, runs = payloads.shape
    with _launch("rle_expand_many", k=k, runs=runs, total=int(total)):
        return expand_many(payloads, bounds, total)


def mul_segsum(seg: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Per-segment sum of x*y over sorted segment ids (int64 / float64)."""
    with _launch("mul_segsum", n=int(seg.shape[0]),
                 segments=int(num_segments),
                 dtype="float64" if x.is_floating_point()
                 or y.is_floating_point() else "int64"):
        return _mul_segsum(seg, x, y, num_segments)


def run_boundaries(keys: torch.Tensor) -> torch.Tensor:
    """Run-start flags (int32) over sorted int32 / int64 keys."""
    with _launch("run_boundaries", n=int(keys.shape[0]),
                 key_bytes=keys.element_size()):
        return _run_boundaries(keys)


def group_by_count(keys: torch.Tensor):
    """GROUP BY sorted keys: (segment ids int32, counts int64, num_groups).

    Composition of the two build kernels: run_boundaries -> cumsum ->
    mul_segsum(ones, ones).  One host sync, for the group count.
    """
    flags = run_boundaries(keys)
    seg = torch.cumsum(flags, 0, dtype=torch.int32).sub_(1)
    num = int(seg[-1]) + 1 if seg.numel() else 0
    ones = torch.ones(seg.shape[0], dtype=torch.int64, device=seg.device)
    counts = mul_segsum(seg, ones, ones, num)
    return seg, counts, num


def dense_message(phi: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[P, K] = phi[P, V] @ m[V, K] in the counting semiring (int32 -> int64
    counts, float32 -> float32)."""
    with _launch("dense_message", p=int(phi.shape[0]), v=int(phi.shape[1]),
                 k=int(m.shape[1]) if m.dim() == 2 else 0,
                 dtype=str(phi.dtype).removeprefix("torch.")):
        return _dense_message(phi, m)
