#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

    python3 chip_smoke.py [--out FILE]      # from the repository root

Phases, each fatal on failure (exit code 1, no result line):

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build every kernel of the path from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together) and print ``-Xptxas -v``;
3. each kernel (``expand_many``, ``mul_segsum``, ``run_boundaries``,
   ``expand_gather``, ``dense_message``) against its plain PyTorch version
   on small edge cases;
4. ``lastfm_A1`` at Last.fm-2k scale (HetRec 2011: 1,892 users, 17,632
   artists) through ``repro_torch.GraphicalJoin(...).run()`` and
   ``.desummarize()`` on the card, held exactly against the same package's
   numpy generation and numpy desummarization.  ``desummarize`` runs after
   ``run()`` (on the device memo that generation leaves: no upload, no
   host prefix sums, both checked), again, and on a memo-free copy of the
   GFJS (which uploads its levels), the three ``torch.equal``; each call's
   ``engine:upload`` / ``engine:download`` bytes, ``summarize``'s split
   between its ``gfjs:level:*`` and ``engine:download`` spans, the memo's
   ``aux_nbytes``, peak device bytes, and the card's busy share of
   ``run()`` and ``desummarize`` (profiler trace);
5. ``lastfm_A2`` at the same scale, generated and desummarized on the card
   (codes kept on the device), checked by its join size, its column
   lengths and windows against the numpy ``desummarize_range``; the same
   three desummarize calls (the first call's columns freed before the
   second; the memo-free copy's ``torch.equal`` to the second's), and the
   routes that download a level's int32 codes as int64 (widened on the
   card or on the host, pageable or through pinned staging) timed on its
   deepest level;
6. the summary side on the card: ``GraphicalJoin.aggregate`` over the
   GFJS of phases 4-5 (COUNT, GROUP BY, SUM, MEAN, a filtered GROUP BY, a
   store -> load -> GROUP BY round trip), each held against the same frame
   on ``device="cpu"`` and split into host, upload and device time; and
   ``engine.build_factor`` (GROUP BY COUNT on the card) over the 38.3M
   desummarized ``(U1, A2)`` rows of lastfm_A1, held against numpy
   ``Factor.from_columns`` and against the summary's GROUP BY;
7. the kernel API and the dense message path at the same scale, on the
   card: ``engine.maybe_dense_message`` over the ``user_friends`` potential
   (1,892 x 1,892) recomputes lastfm_A1's and lastfm_A2's join sizes
   (one message, then two chained), each message held bit for bit against
   the numpy route (``multiply`` then ``marginalize_out``); ``ops.rle_expand``
   and ``ops.expand_indices`` over lastfm_A1's 1,004,489-run level, held
   against phase 4's column and the plain versions; and ``desummarize``
   twice, the second call reusing every level's memoized device bounds;
8. each kernel at the shapes its path gave it (recorded by its ``kernel:``
   spans in phases 4-7; for the new kernels also the reference benchmark's
   shapes): exact against its plain version, and timed with CUDA events
   beside its bound, the plain version and one PyTorch call computing the
   same function where there is one (``repeat_interleave``, ``index_add_``,
   ``torch.matmul``); the dense message also per call in a CUDA graph (the card's time without the
   host's launch cost), cold (rotating over copies of phi that overflow
   L2) beside warm, and swept over K, thin kernel against tiled; each
   redesigned kernel's time under its previous design beside its new one;
9. the serving path on the card, at the same scale, under one tracer:
   (a) ``JoinServer(JoinService(device="cuda", incremental=True))``:
   lastfm_A1 raced cold by 8 threads (one traced build on numpy, 7
   ``"collapsed"`` replies), then ``"memory"``; COUNT, SUM, MEAN, GROUP BY
   and a filtered GROUP BY through the service, each held against the
   same frame on ``device="cpu"`` and split into host, transfer and card
   time; batched ``lookup`` of all user ids from 8 threads against
   ``lookup_rows``; a 1 % append to ``user_friends`` (ids past the
   domain), after which the frame is ``"refreshed"`` and equal, level for
   level and in its aggregates and columns, to a cold rebuild on the card.
   (b) ``JoinService(device="cuda", incremental=False)`` with a 1 GiB
   budget: lastfm_A1 under two plans (the second evicts the first to disk;
   once no reply holds it, the card's allocated bytes fall by its memo;
   it comes back from ``"disk"`` with the same answers), lastfm_A2 built
   on the card, warm, COUNT and GROUP BY against ``device="cpu"``, rebuilt
   after ``cache.clear()`` with message-cache hits and an identical GFJS,
   and ``invalidate`` freeing its memo.  The trace passes
   ``obs.check.validate(expect_server=True, expect_msgcache=True)``;
10. partitioned builds on the card, at the same scale, under one tracer:
   (a) lastfm_A1 with ``partitions=4`` (thread executor): each shard equal
   level for level to the same shards generated on numpy, the shard join
   sizes summing to phase 4's, the desummarized rows equal to phase 4's
   as a multiset (packed into one int64 key and sorted on the card),
   COUNT, SUM, MEAN, GROUP BY A1 and the filtered GROUP BY through
   ``ShardedSummaryFrame`` equal to phase 6's monolithic answers, and
   ``partition_histogram`` on the card equal to ``np.bincount`` of the
   numpy hash; (b) lastfm_A2 with ``partitions=4``: the join size, COUNT
   and GROUP BY A2 against phases 5-6, and each shard's column windows
   against numpy ``desummarize_range``; (c) lastfm_A1 with 2 shards
   generated on numpy in spawned workers (``shard_executor="process"``),
   equal to the thread executor's; (d) ``JoinService(partitions=4)``:
   computed, memory, answers equal (a)'s, an append rebuilds, and
   ``invalidate`` frees the shards' memos.  Each prints its shard report,
   ``aux_nbytes`` and peak device bytes; the trace passes
   ``obs.check.validate(expect_shards=True)``;
11. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Kernel launch counts are zeroed just before phase 4 and read just after
phase 5 (``expand_many``: the main path), zeroed again just before phase 6
and read just after it (``mul_segsum``, ``run_boundaries``: the summary
path), again around phase 7's path (``expand_gather``,
``dense_message``), around phase 9 (``expand_many``, ``mul_segsum``,
``run_boundaries``: the serving path) and around phase 10 (the same
three: the partitioned path).  ``--out`` writes the per-shape
measurements as JSON.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM data sheet, CUDA cores
# CUDA C++ Programming Guide, arithmetic instruction throughput: 32-bit
# integer multiply-add, 64 per clock per SM at compute capability 9.0
IMAD_PER_CLOCK_PER_SM = 64
# dense_message.cu: each thread's 4 x 4 micro-tile over a 16-deep V step
DENSE_MACS_PER_STEP = 4 * 4 * 16
LASTFM_2K = dict(n_users=1892, n_artists=17632, artists_per_user=49,
                 friends_per_user=7, seed=0)
L2_BYTES = 50 * 2**20              # H100 SXM; the device's own where known
# the times of the two redesigned kernels under their previous designs (a
# thread per output; 64 x 64 tiles at every K), from this script on an
# H100 80GB HBM3 at 700 W (PERF.md §6); expand_many's is the kernels
# line's sum over lastfm_A1's shapes
PREVIOUS_MS = {("dense_message", 1892, 1892, 1, "int32"): 0.2843,
               ("dense_message", 2048, 2048, 128, "float32"): 0.1391,
               ("dense_message", 2048, 2048, 128, "int32"): 0.3426,
               ("expand_gather", "lastfm_A1"): 0.5639,
               ("expand_gather", "benchmark"): 0.1221,
               ("expand_many", "lastfm_A1"): 2.9388}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| of two [K, n] int32 tensors, row by row (an
    int64 copy of a whole 20 GB output would not fit beside it)."""
    if torch.equal(got, want):
        return 0
    return max(int((g.long() - w.long()).abs().max())
               for g, w in zip(got, want) if g.numel())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


# -- phase 1-2: the card and the build ---------------------------------------

def device_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    build.build(names)
    print(f"build: {names} in {time.perf_counter() - t0:.3f}s "
          f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name in names:
        for line in build.PTXAS.get(name, "(cached build)").splitlines():
            if "registers" in line or "Compiling" in line \
                    or "cached" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")


# -- phase 3: small edge cases ----------------------------------------------

def edge_cases():
    """(name, payloads [K, runs] int32, freqs [runs]) from fixed seeds."""
    rng = np.random.default_rng(0)
    out = []
    for n_runs, k in ((1, 1), (7, 2), (513, 5), (1200, 3)):
        out.append((f"sweep-{n_runs}x{k}",
                    rng.integers(0, 1 << 20, (k, n_runs)).astype(np.int32),
                    rng.integers(1, 9, n_runs)))
    freqs = rng.integers(0, 4, 600)
    freqs[::7] = 0
    out.append(("empty-runs",
                rng.integers(0, 1 << 20, (3, 600)).astype(np.int32), freqs))
    out.append(("zero-length-edges", np.arange(14, dtype=np.int32)
                .reshape(2, 7), np.asarray([0, 0, 3, 0, 2, 0, 0])))
    out.append(("single-run", np.asarray([[9], [4]], np.int32),
                np.asarray([6])))
    out.append(("ragged-total",
                rng.integers(0, 1 << 30, (1, 777)).astype(np.int32),
                rng.integers(1, 7, 777)))
    out.append(("all-runs-empty", np.ones((4, 5), np.int32),
                np.zeros(5, np.int64)))
    out.append(("no-runs", np.zeros((3, 0), np.int32), np.zeros(0, np.int64)))
    return out


def check_edge_cases(dev) -> int:
    """expand_many against its plain version and np.repeat on the cases
    above and on the card tests' (tests/torch_cases.py: the per-tile run
    window's edges, rows off the 16-byte grid, Zipf run lengths)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import expand_cases
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.ref import expand_many_ref
    err = 0
    cases = edge_cases() + [(n, p, f) for n, (p, f) in
                            sorted(expand_cases().items())]
    for name, payloads, freqs in cases:
        bounds = np.cumsum(freqs).astype(np.int32)
        total = int(bounds[-1]) if len(bounds) else 0
        p = torch.from_numpy(payloads).to(dev)
        b = torch.from_numpy(bounds).to(dev)
        got = expand_many(p, b, total)
        want = expand_many_ref(p, b, total)
        sync(dev)
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
        e = max_abs_err(got, want)
        check(e == 0, f"{name}: kernel differs from plain version by {e}")
        oracle = np.stack([np.repeat(r, freqs) for r in payloads])
        check(np.array_equal(got.cpu().numpy(), oracle), f"{name}: np.repeat")
        err = max(err, e)
    print(f"edge cases: expand_many {len(cases)} exact against the plain "
          f"version")
    return err


def check_summary_kernel_cases(dev):
    """mul_segsum and run_boundaries against their plain versions on the
    card tests' edge cases (tests/torch_cases.py): N = 0 and 1, one
    segment over every tile, every entry its own segment, changes on tile
    and thread edges, gaps, past-2^40 and negative int64, float64,
    int32 extremes.  Exact, except non-integral float64 sums (rtol 1e-12:
    the kernel adds in tile order, the plain version in another).
    Returns each kernel's largest exact-case error."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import boundaries_cases, segsum_cases
    from repro_torch.kernels.mul_segsum import mul_segsum
    from repro_torch.kernels.ref import mul_segsum_ref, run_boundaries_ref
    from repro_torch.kernels.run_boundaries import run_boundaries
    seg_err = 0
    cases = segsum_cases()
    for name, (seg, x, y, s) in cases.items():
        args = [torch.from_numpy(a).to(dev) for a in (seg, x, y)]
        got, want = mul_segsum(*args, s), mul_segsum_ref(*args, s)
        sync(dev)
        check(got.dtype == want.dtype and got.shape == (s,),
              f"mul_segsum {name}: {got.dtype} {tuple(got.shape)}")
        if name == "f64":
            check(torch.allclose(got, want, rtol=1e-12, atol=1e-9),
                  f"mul_segsum {name}: beyond rtol 1e-12")
            check(torch.equal(got, mul_segsum(*args, s)),
                  f"mul_segsum {name}: differs between two runs")
            continue
        e = float((got - want).abs().max()) if s else 0.0
        check(e == 0, f"mul_segsum {name}: differs from plain by {e}")
        seg_err = max(seg_err, e)
    b_err = 0
    bcases = boundaries_cases()
    for name, keys in bcases.items():
        k = torch.from_numpy(keys).to(dev)
        got, want = run_boundaries(k), run_boundaries_ref(k)
        sync(dev)
        e = int((got - want).abs().max()) if keys.size else 0
        check(e == 0, f"run_boundaries {name}: differs from plain by {e}")
        b_err = max(b_err, e)
    print(f"edge cases: mul_segsum {len(cases)}, run_boundaries "
          f"{len(bcases)}, against the plain versions")
    return seg_err, b_err


def dense_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| (0 when equal; float64 for the measure only)."""
    if torch.equal(got, want):
        return 0
    return float((got.double() - want.double()).abs().max())


def check_message_kernel_cases(dev):
    """expand_gather and dense_message against their plain versions on the
    card tests' edge cases (tests/torch_cases.py): a single run,
    zero-length runs (100,000 in one tile), total 0, float32 payloads whose
    NaN and -0.0 bit patterns must survive, totals at a block and a tile
    edge, a run over many tiles; P, V, K in {1, 63, 64, 65, 1025}, K about
    THIN_K, V % 4 in {0, 1, 3}, P = 1 with V = 2^20 (the V split),
    misaligned offset views, empty dimensions, products and sums past 2^24
    and 2^40, int64 wrapping, negative counts, and float32 sums of
    integers below 2^24 (exact in the kernel's f32 and the plain version's
    f64).  All exact (float payloads bit for bit).  Returns each kernel's
    largest error."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import dense_cases, dense_tensors, gather_cases
    from repro_torch.kernels.dense_message import dense_message
    from repro_torch.kernels.expand_gather import expand_gather
    from repro_torch.kernels.ref import dense_message_ref, expand_gather_ref
    g_err = 0
    gcases = gather_cases()
    for name, (payload, freqs) in gcases.items():
        bounds = np.cumsum(freqs).astype(np.int32)
        total = int(bounds[-1]) if len(bounds) else 0
        p = torch.from_numpy(payload).to(dev)
        b = torch.from_numpy(bounds).to(dev)
        got = expand_gather(p, b, total).view(torch.int32)
        want = expand_gather_ref(p, b, total).view(torch.int32)
        sync(dev)
        check(got.shape == (total,), f"expand_gather {name}: shape")
        e = max_abs_err(got[None], want[None])
        check(e == 0, f"expand_gather {name}: differs from plain by {e}")
        check(np.array_equal(got.cpu().numpy(),
                             np.repeat(payload, freqs).view(np.int32)),
              f"expand_gather {name}: np.repeat")
        g_err = max(g_err, e)
    d_err = 0
    dcases = dense_cases()
    for name, (phi, m) in dcases.items():
        a, b = dense_tensors(name, phi, m, dev)
        got, want = dense_message(a, b), dense_message_ref(a, b)
        sync(dev)
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"dense_message {name}: {got.dtype} {tuple(got.shape)}")
        e = dense_err(got, want)
        check(e == 0, f"dense_message {name}: differs from plain by {e}")
        d_err = max(d_err, e)
    print(f"edge cases: expand_gather {len(gcases)}, dense_message "
          f"{len(dcases)}, against the plain versions")
    return g_err, d_err


# -- phases 4-5: the main path -----------------------------------------------

def kernel_shapes(tracer, query: str):
    """(phase, k, runs, total) of every expansion launched under a span."""
    spans = {s.span_id: s for s in tracer.spans}
    out = []
    for s in tracer.spans:
        if s.name != "kernel:rle_expand_many":
            continue
        p = spans.get(s.parent_id)
        while p is not None and not p.name.startswith(("gfjs:",
                                                       "desummarize:")):
            p = spans.get(p.parent_id)
        phase = "generate" if p is not None and p.name.startswith("gfjs:") \
            else "desummarize"
        out.append(dict(query=query, phase=phase, k=s.args["k"],
                        runs=s.args["runs"], total=s.args["total"],
                        t0=s.t0))
    return sorted(out, key=lambda r: r["t0"])


def level_seconds(tracer) -> str:
    """Wall seconds of each generation / desummarize level span."""
    return ", ".join(f"{s.name}={s.seconds:.4f}" for s in tracer.spans
                     if s.name.startswith(("gfjs:level", "desummarize:level")))


def traced_call(fn, dev, tracer) -> dict:
    """One synchronized call of ``fn``: its result, wall seconds, and the
    bytes and seconds of the ``engine:upload`` / ``engine:download`` spans
    and the seconds of the ``gfjs:level:*`` spans it recorded."""
    since = len(tracer.spans)
    out, wall = timed(fn, dev)
    spans = tracer.spans[since:]

    def total(name, key):
        return sum(s.seconds if key == "s" else s.args.get(key, 0)
                   for s in spans if s.name.startswith(name))
    return dict(out=out, wall=wall,
                upload_bytes=total("engine:upload", "bytes"),
                download_bytes=total("engine:download", "bytes"),
                upload_s=total("engine:upload", "s"),
                download_s=total("engine:download", "s"),
                level_s=total("gfjs:level:", "s"),
                expand_launches=sum(s.name == "kernel:rle_expand_many"
                                    for s in spans),
                identity_levels=sum(bool(s.args.get("identity"))
                                    for s in spans
                                    if s.name.startswith("desummarize:")))


def fmt_call(name: str, c: dict) -> str:
    return (f"  {name} {c['wall']:.4f}s: engine:upload {c['upload_bytes']} B "
            f"({c['upload_s']:.4f}s), engine:download {c['download_bytes']} "
            f"B ({c['download_s']:.4f}s), expand_many calls "
            f"{c['expand_launches']}")


def plain(c: dict) -> dict:
    """A traced call's numbers, without its result (for ``--out``)."""
    return {k: v for k, v in c.items() if k != "out"}


def memo_free_copy(gfjs):
    """The same summary rebuilt from its levels, as storage or the numpy
    generator gives it: no device memo, so desummarize uploads it."""
    from repro_torch.core.gfjs import GFJS
    return GFJS(gfjs.levels, gfjs.column_order, gfjs.join_size,
                gfjs.domains)


def check_memo(gfjs, call: dict, what: str, host_bounds=()) -> None:
    """A desummarize on the memo: no upload, and no host prefix sums
    beyond ``host_bounds``, the levels whose ``GFJS.bounds`` a numpy path
    (``desummarize_range``) had made before the call."""
    check(call["upload_bytes"] == 0, f"{what} uploaded "
          f"{call['upload_bytes']} B")
    check(set(gfjs._bounds) == set(host_bounds),
          f"{what} ran a host np.cumsum")


def busy_share(fn, dev, wall: float) -> dict:
    """The card's busy seconds over one profiled call of ``fn`` (kernels
    plus copies, from the Chrome trace) against the wall seconds of an
    unprofiled call of it."""
    kern, copy, ours = device_seconds(fn, dev)
    if kern is None:
        return dict(kernels=None, copies=None, share=None)
    return dict(kernels=kern, copies=copy, our_launches=ours,
                share=(kern + copy) / wall)


def fmt_busy(b: dict) -> str:
    if b["share"] is None:
        return "no device activity recorded"
    return (f"busy {b['share']:.4%} ({b['kernels']:.6f}s kernels, "
            f"{b['our_launches']} of ours, + {b['copies']:.6f}s copies)")


def run_a1(cat, query, dev, tracer) -> dict:
    """lastfm_A1 on the device, exactly against the numpy path."""
    import repro_torch
    from repro_torch.core.gfjs import desummarize as np_desummarize
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gj = repro_torch.GraphicalJoin(cat, query, device=dev, tracer=tracer)
    run = traced_call(gj.run, dev, tracer)
    gfjs, t_run = run["out"], run["wall"]
    aux = gfjs.aux_nbytes()
    peak_run = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    first = traced_call(lambda: gj.desummarize(gfjs, decode=False), dev,
                        tracer)
    check_memo(gfjs, first, "lastfm_A1 desummarize after run()")
    again = traced_call(lambda: gj.desummarize(gfjs, decode=False), dev,
                        tracer)
    check_memo(gfjs, again, "lastfm_A1 second desummarize")
    copy = memo_free_copy(gfjs)
    free = traced_call(lambda: gj.desummarize(copy, decode=False), dev,
                       tracer)
    codes = first["out"]
    for v in codes:
        check(torch.equal(codes[v], again["out"][v]), f"second {v}")
        check(torch.equal(codes[v], free["out"][v]), f"memo-free copy {v}")
    del again["out"], free["out"], copy
    want_codes = np_desummarize(gfjs, decode=False)
    for v in want_codes:
        check(np.array_equal(codes[v].cpu().numpy(), want_codes[v]),
              f"codes {v} vs numpy")
    del want_codes
    t_expand = first["wall"]
    host, t_d2h = timed(lambda: {v: c.cpu().numpy()
                                 for v, c in codes.items()}, dev)
    _, t_decode = timed(lambda: {v: gfjs.domains[v].decode(c)
                                 for v, c in host.items()}, dev)
    del codes, host, first["out"]
    values, t_full = timed(lambda: gj.desummarize(gfjs), dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    phases = {k: float(v) for k, v in gj.timings.items()}

    # the card's busy share of the main path: a second run() on a new
    # facade, and a desummarize on the memo
    again_gj = repro_torch.GraphicalJoin(cat, query, device=dev)
    busy = dict(run=busy_share(again_gj.run, dev, t_run),
                desummarize=busy_share(
                    lambda: gj.desummarize(gfjs, decode=False), dev,
                    t_expand))

    ref = repro_torch.GraphicalJoin(cat, query, device=dev,
                                    generation_backend="numpy")
    ref_gfjs, t_ref = timed(ref.run, dev)
    check(ref.plan().order == gj.plan().order, "plan order")
    check(gfjs.join_size == ref_gfjs.join_size == gj.join_size(),
          "join size")
    check(len(gfjs.levels) == len(ref_gfjs.levels), "level count")
    for la, lb in zip(gfjs.levels, ref_gfjs.levels):
        check(la.vars == lb.vars and np.array_equal(la.freq, lb.freq)
              and all(np.array_equal(la.key_cols[v], lb.key_cols[v])
                      for v in la.vars), f"level {la.vars} vs numpy")
    want = np_desummarize(ref_gfjs, decode=True)
    check(list(values) == list(want), "column order")
    for v in want:
        check(np.array_equal(values[v], want[v]), f"decoded column {v}")
    rows = gfjs.join_size
    print(f"lastfm_A1: |Q|={rows} x {len(values)} cols, order "
          f"{gj.plan().order}, runs/level "
          f"{[lvl.num_runs for lvl in gfjs.levels]}")
    print(f"  phases s: {json.dumps(phases)}")
    print(f"  run {t_run:.4f}s (numpy-generation run {t_ref:.4f}s, its "
          f"summarize {ref.timings['summarize']:.4f}s); summarize split: "
          f"gfjs:level:* spans {run['level_s']:.4f}s, engine:download "
          f"spans {run['download_s']:.4f}s ({run['download_bytes']} B), "
          f"engine:upload {run['upload_bytes']} B, expand_many calls "
          f"{run['expand_launches']}")
    print(f"  after run(): aux_nbytes {aux} (the device memo), peak device "
          f"bytes {peak_run}")
    for name, c in (("desummarize after run()", first), ("again", again),
                    ("on a memo-free copy", free)):
        print(fmt_call(name, c) + f", identity levels "
              f"{c['identity_levels']}")
    print(f"  desummarize D2H {t_d2h:.4f}s, decode {t_decode:.4f}s, full "
          f"decode=True {t_full:.4f}s; all three calls' codes equal "
          f"(torch.equal) and equal to numpy")
    print(f"  rows/s: device expansion {rows / t_expand:.6g}, "
          f"full {rows / t_full:.6g}; peak device bytes {peak}")
    print(f"  card: run() {fmt_busy(busy['run'])}; desummarize "
          f"{fmt_busy(busy['desummarize'])}")
    print(f"  level spans s: {level_seconds(tracer)}")
    print("  exact against the numpy path: GFJS levels and decoded columns")
    return dict(gfjs=gfjs, rows=rows, t_run=t_run, t_expand=t_expand,
                t_d2h=t_d2h, t_decode=t_decode, t_full=t_full, peak=peak,
                peak_run=peak_run, aux_nbytes=aux, run=plain(run),
                first=plain(first), again=plain(again), memo_free=plain(free),
                busy=busy, phases=phases, t_numpy_run=t_ref,
                numpy_summarize=float(ref.timings["summarize"]))


def staged_download(t: torch.Tensor, dtype) -> np.ndarray:
    """The engine's staged download on one host thread: two reused pinned
    buffers of ``STAGE_BYTES``, the card copying one chunk while the host
    moves the one before out of its buffer (widening it on the way)."""
    from repro_torch.core.engine import STAGE_BYTES
    n = t.numel()
    out = np.empty(n, dtype)
    chunk = STAGE_BYTES // t.element_size()
    bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8,
                        pin_memory=True).view(t.dtype) for _ in range(2)]
    done = [torch.cuda.Event(), torch.cuda.Event()]

    def copy_chunk(i):
        lo = i * chunk
        m = min(chunk, n - lo)
        bufs[i % 2][:m].copy_(t[lo:lo + m], non_blocking=True)
        done[i % 2].record()
    chunks = -(-n // chunk)
    if chunks:
        copy_chunk(0)
    for i in range(chunks):
        if i + 1 < chunks:
            copy_chunk(i + 1)
        done[i % 2].synchronize()
        lo = i * chunk
        m = min(chunk, n - lo)
        np.copyto(out[lo:lo + m], bufs[i % 2][:m].numpy())
    return out


def threaded_download(t: torch.Tensor, pool, threads: int) -> np.ndarray:
    """A 1-D card tensor to a new numpy array of its dtype, pageable, one
    slice for each of ``pool``'s ``threads``."""
    n = t.numel()
    out = np.empty(n, torch.empty(0, dtype=t.dtype).numpy().dtype)
    host = torch.from_numpy(out)
    step = -(-n // threads) if n else 1
    list(pool.map(lambda lo: host[lo:lo + step].copy_(t[lo:lo + step]),
                  range(0, n, step)))
    return out


def download_routes(codes: torch.Tensor, dev) -> dict:
    """Seconds of the routes that bring int32 device codes home as int64
    numpy (the ``LevelSummary`` contract), and an int64 array (the run
    lengths) home, the engine's ``_download`` among them; each result
    checked against the first."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import engine
    threads = engine.STAGE_THREADS
    mb = engine.STAGE_BYTES >> 20
    pool = ThreadPoolExecutor(threads)
    want = None
    out = {}
    wide = None
    routes = {
        "int32: widen on the card, pageable download":
            lambda: codes.to(torch.int64).cpu().numpy(),
        "int32: pageable download, widen on the host (the parent's)":
            lambda: codes.cpu().numpy().astype(np.int64),
        f"int32: pinned 2 x {mb} MB staging, widen on 1 host thread":
            lambda: staged_download(codes, np.int64),
        f"int32: engine._download, pinned 2 x {mb} MB staging, widen on "
        f"{threads} host threads": lambda: engine._download(codes, np.int64),
        f"int32: widen on the card, pageable download on {threads} threads":
            lambda: threaded_download(codes.to(torch.int64), pool, threads),
        "int64: pageable download (the parent's)":
            lambda: wide.cpu().numpy(),
        f"int64: engine._download, pinned 2 x {mb} MB staging, {threads} "
        f"host threads": lambda: engine._download(wide),
    }
    for name, fn in routes.items():
        if name.startswith("int64") and wide is None:
            wide = codes.to(torch.int64)
        got, t = timed(fn, dev)
        if want is None:
            want = got
        else:
            check(np.array_equal(got, want), f"download route {name}")
        del got
        out[name] = t
    pool.shutdown()
    return out


def run_a2(cat, query, dev, tracer) -> dict:
    """lastfm_A2 on the device; codes stay there; windows vs numpy; the
    memoized, repeated and memo-free desummarize equal."""
    import repro_torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gj = repro_torch.GraphicalJoin(cat, query, device=dev, tracer=tracer)
    run = traced_call(gj.run, dev, tracer)
    gfjs, t_run = run["out"], run["wall"]
    aux = gfjs.aux_nbytes()
    peak_run = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    rows = gfjs.join_size
    check(rows == gj.join_size() == gj.generator.join_size, "join size")
    deepest = gfjs._launch[len(gfjs.levels) - 1][1][1][0]
    routes = download_routes(deepest, dev)
    del deepest

    rng = np.random.default_rng(1)
    starts = [0, rows // 2, max(rows - 4096, 0)] + \
        [int(x) for x in rng.integers(0, max(rows - 4096, 1), 3)]

    def check_columns(codes, what):
        check(list(codes) == list(gfjs.column_order), f"{what}: order")
        for v, c in codes.items():
            check(c.shape == (rows,) and c.device.type == dev.type,
                  f"{what} column {v}: {tuple(c.shape)} on {c.device}")
        for lo in starts:
            hi = min(lo + 4096, rows)
            win = gj.desummarize_range(gfjs, lo, hi, decode=False)
            for v in win:
                check(np.array_equal(codes[v][lo:hi].cpu().numpy(), win[v]),
                      f"{what}: window [{lo},{hi}) of {v}")
        return {v: int(c.sum(dtype=torch.int64)) for v, c in codes.items()}

    first = traced_call(lambda: gj.desummarize(gfjs, decode=False), dev,
                        tracer)
    check_memo(gfjs, first, "lastfm_A2 desummarize after run()")
    t_expand = first["wall"]
    sums = check_columns(first.pop("out"), "after run()")
    # the first columns go before the second call: the peak stays that of
    # one set of columns beside the memo
    host_bounds = set(gfjs._bounds)
    again = traced_call(lambda: gj.desummarize(gfjs, decode=False), dev,
                        tracer)
    check_memo(gfjs, again, "lastfm_A2 second desummarize", host_bounds)
    check(check_columns(again["out"], "again") == sums,
          "second desummarize's column sums")
    copy = memo_free_copy(gfjs)
    free = traced_call(lambda: gj.desummarize(copy, decode=False), dev,
                       tracer)
    for v in gfjs.column_order:
        check(torch.equal(free["out"][v], again["out"][v]),
              f"memo-free copy {v}")
    del again["out"], free["out"], copy
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    phases = {k: float(v) for k, v in gj.timings.items()}
    print(f"lastfm_A2: |Q|={rows} x {len(gfjs.column_order)} cols, order "
          f"{gj.plan().order}, runs/level "
          f"{[lvl.num_runs for lvl in gfjs.levels]}")
    print(f"  phases s: {json.dumps(phases)}")
    print(f"  run {t_run:.4f}s; summarize split: gfjs:level:* spans "
          f"{run['level_s']:.4f}s, engine:download spans "
          f"{run['download_s']:.4f}s ({run['download_bytes']} B), "
          f"engine:upload {run['upload_bytes']} B, expand_many calls "
          f"{run['expand_launches']}")
    print(f"  after run(): aux_nbytes {aux} (the device memo), peak device "
          f"bytes {peak_run}")
    print("  download routes of the deepest level's codes "
          f"({gfjs.levels[-1].num_runs} int32), s: " + ", ".join(
              f"{k} {v:.4f}" for k, v in routes.items()))
    for name, c in (("desummarize after run()", first), ("again", again),
                    ("on a memo-free copy", free)):
        print(fmt_call(name, c) + f" ({rows / c['wall']:.6g} rows/s), "
              f"identity levels {c['identity_levels']}")
    print(f"  peak device bytes {peak}")
    print(f"  level spans s: {level_seconds(tracer)}")
    print(f"  {len(starts)} windows of the first and second calls exact "
          f"against numpy desummarize_range; the memo-free copy's columns "
          f"equal the second call's (torch.equal)")
    return dict(gfjs=gfjs, rows=rows, t_run=t_run, t_expand=t_expand,
                peak=peak, peak_run=peak_run, aux_nbytes=aux, run=plain(run),
                first=plain(first), again=plain(again), memo_free=plain(free),
                download_routes=routes, phases=phases)


# -- phase 6: the summary side ----------------------------------------------

def same(got, want, what: str) -> None:
    """Integers exactly, floats to rtol 1e-12, dicts column by column."""
    if isinstance(want, dict):
        check(list(got) == list(want), f"{what}: columns {list(got)}")
        for k in want:
            same(got[k], want[k], f"{what}[{k}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    check(g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}")
    if g.dtype.kind == "f" or w.dtype.kind == "f":
        check(np.allclose(g, w, rtol=1e-12, atol=0), f"{what}: beyond rtol")
    else:
        check(np.array_equal(g, w), f"{what}: differs")


OUR_KERNELS = ("segsum_pass", "boundaries_kernel", "expand_many_kernel")


def device_seconds(fn, dev):
    """(kernel s, copy s, launches of our kernels) that torch.profiler
    records on the card over one call of ``fn``, read from its Chrome
    trace: the kernels launched through ctypes belong to no PyTorch op,
    so only the trace's CUPTI records (not ``prof.events()``) hold them.
    (None, None, 0) where it records no device activity."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            with record_function("aggregate"):
                fn()
            sync(dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
    except RuntimeError as exc:      # a measurement, not a check
        print(f"  torch.profiler failed: {exc}")
        return None, None, 0
    kern = copy = 0.0
    ours = 0
    for e in events:
        cat = e.get("cat")
        if cat == "kernel":
            kern += e.get("dur", 0)
            ours += any(k in e.get("name", "") for k in OUR_KERNELS)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copy += e.get("dur", 0)
    if kern == 0 and copy == 0:
        return None, None, 0
    return kern / 1e6, copy / 1e6, ours


def split_call(fn, dev, tracers):
    """One call on the card: (result, seconds split).  ``upload`` and
    ``download`` sum the engine's transfer spans (a download also waits
    for the kernels before it); ``host`` is the rest of the wall time;
    ``kernels`` / ``copies`` are the card's own busy times in a second,
    profiled call (``our_launches``: how many of its kernel records are
    this repository's kernels)."""
    from repro_torch.obs.trace import Tracer
    tr = Tracer()
    tracers.append(tr)

    def call():
        with tr.span("aggregate"):
            return fn()
    out, wall = timed(call, dev)
    up = sum(sp.seconds for sp in tr.find("engine:upload"))
    down = sum(sp.seconds for sp in tr.find("engine:download"))
    kern, copy, ours = device_seconds(fn, dev)
    return out, dict(wall=wall, upload=up, download=down,
                     host=wall - up - down, kernels=kern, copies=copy,
                     our_launches=ours)


def split_aggregate(gj, args, kw, gfjs, dev, tracers):
    """``gj.aggregate`` on the card, split as :func:`split_call`."""
    return split_call(lambda: gj.aggregate(*args, gfjs=gfjs, **kw), dev,
                      tracers)


def fmt_split(t: dict) -> str:
    dev = "no device activity recorded" if t["kernels"] is None else \
        (f"{t['kernels']:.6f}s kernels ({t['our_launches']} of ours) + "
         f"{t['copies']:.6f}s copies")
    return (f"{t['wall']:.4f}s = host {t['host']:.4f} + upload "
            f"{t['upload']:.4f} + download/wait {t['download']:.4f}; "
            f"card: {dev}")


def run_summary(cat, queries, a1, a2, dev, tracers, answers) -> dict:
    """Phase 6: aggregates from the GFJS and build_factor on the card.
    Each query's ``(name, args, kw, answer)`` go into ``answers`` (phase
    10 holds the sharded frames against them)."""
    import tempfile
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.core.potentials import Factor
    from repro_torch.obs.trace import Tracer
    gfjs = a1["gfjs"]
    gj = repro_torch.GraphicalJoin(cat, queries["lastfm_A1"], device=dev)
    cpu = repro_torch.GraphicalJoin(cat, queries["lastfm_A1"], device="cpu")
    per_user = cpu.aggregate("count", by=["U1"], gfjs=gfjs)
    top = per_user["U1"][int(np.argmax(per_user["count"]))]
    specs = [("count", ("count",), {}),
             ("count by U1,A2", ("count",), dict(by=["U1", "A2"])),
             ("count by A1", ("count",), dict(by=["A1"])),
             ("sum U2", ("sum", "U2"), {}),
             ("mean U2", ("mean", "U2"), {}),
             (f"count by A2 where U1={top}", ("count",),
              dict(by=["A2"], where={"U1": top}))]
    out = {"lastfm_A1": {}, "lastfm_A2": {}}
    results = {}
    print(f"summary side, lastfm_A1 (runs/level "
          f"{[lvl.num_runs for lvl in gfjs.levels]}):")
    for name, args, kw in specs:
        got, t = split_aggregate(gj, args, kw, gfjs, dev, tracers)
        want, t_cpu = timed(lambda: cpu.aggregate(*args, gfjs=gfjs, **kw),
                            dev)
        same(got, want, name)
        results[name] = got
        t["cpu_wall"] = t_cpu
        out["lastfm_A1"][name] = t
        print(f"  {name}: {fmt_split(t)}; device='cpu' {t_cpu:.4f}s; "
              f"equal")
    answers["lastfm_A1"] = [(name, args, kw, results[name])
                            for name, args, kw in specs]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "lastfm_A1.gfjs")
        nbytes, t_store = timed(lambda: gj.store(gfjs, path), dev)
        back, t_load = timed(lambda: repro_torch.GraphicalJoin.load(path),
                             dev)
    name = "store -> load -> count by U1,A2"
    got, t = split_aggregate(gj, ("count",), dict(by=["U1", "A2"]), back,
                             dev, tracers)
    same(got, results["count by U1,A2"], name)
    t.update(store=t_store, load=t_load, file_bytes=nbytes)
    out["lastfm_A1"][name] = t
    print(f"  {name}: store {t_store:.4f}s ({nbytes} B), load "
          f"{t_load:.4f}s, aggregate {fmt_split(t)}; equal")
    del back

    # GROUP BY COUNT on the card over the desummarized rows
    codes = gj.desummarize(gfjs, decode=False)
    cols = {v: codes[v].cpu().numpy() for v in ("U1", "A2")}
    del codes
    sizes = {v: gfjs.domains[v].size for v in cols}
    tr = Tracer()
    tracers.append(tr)

    def build():
        with tr.span("build_factor"):
            return engine.build_factor(cols, sizes, device=dev)
    fac, t_bf = timed(build, dev)
    ref, t_np = timed(lambda: Factor.from_columns(cols, sizes), dev)
    check(np.array_equal(fac.keys, ref.keys)
          and np.array_equal(fac.bucket, ref.bucket),
          "build_factor vs Factor.from_columns")
    by = results["count by U1,A2"]
    check(np.array_equal(gfjs.domains["U1"].decode(fac.keys[:, 0]), by["U1"])
          and np.array_equal(gfjs.domains["A2"].decode(fac.keys[:, 1]),
                             by["A2"])
          and np.array_equal(fac.bucket, by["count"]),
          "build_factor vs the summary's GROUP BY U1, A2")
    rows = len(cols["U1"])
    out["build_factor"] = dict(rows=rows, groups=len(fac.bucket),
                               seconds=t_bf, numpy_seconds=t_np)
    print(f"  build_factor over {rows} desummarized (U1, A2) rows: "
          f"{len(fac.bucket)} groups in {t_bf:.4f}s on the card "
          f"(Factor.from_columns {t_np:.4f}s); equal to from_columns and to "
          f"the summary's GROUP BY U1, A2")
    del cols, fac, ref

    g2 = a2["gfjs"]
    gj2 = repro_torch.GraphicalJoin(cat, queries["lastfm_A2"], device=dev)
    cpu2 = repro_torch.GraphicalJoin(cat, queries["lastfm_A2"],
                                     device="cpu")
    print(f"summary side, lastfm_A2 (runs/level "
          f"{[lvl.num_runs for lvl in g2.levels]}):")
    answers["lastfm_A2"] = []
    for name, args, kw in (("count", ("count",), {}),
                           ("sum A2", ("sum", "A2"), {}),
                           ("count by A2", ("count",), dict(by=["A2"]))):
        got, t = split_aggregate(gj2, args, kw, g2, dev, tracers)
        want, t_cpu = timed(lambda: cpu2.aggregate(*args, gfjs=g2, **kw),
                            dev)
        same(got, want, f"lastfm_A2 {name}")
        answers["lastfm_A2"].append((name, args, kw, got))
        t["cpu_wall"] = t_cpu
        out["lastfm_A2"][name] = t
        print(f"  {name}: {fmt_split(t)}; device='cpu' {t_cpu:.4f}s; equal")
    return out


# -- phase 7: the kernel API and the dense message path -----------------------

def friends_potential(cat, parent: str, child: str):
    """Phi(parent, child) = Factor.from_columns of user_friends (user ids
    are already codes 0..n-1), and the per-user artist counts m_ua."""
    from repro_torch.core.potentials import Factor
    uf, ua = cat["user_friends"].columns, cat["user_artists"].columns
    n = int(max(uf["userID"].max(), uf["friendID"].max(),
                ua["userID"].max())) + 1
    phi = Factor.from_columns({parent: uf["userID"], child: uf["friendID"]},
                              {parent: n, child: n})
    return phi, np.bincount(ua["userID"], minlength=n).astype(np.int64)


def dense_split(phi, child, msg, dev) -> dict:
    """Seconds of each step of one ``maybe_dense_message``, each ended by a
    synchronize: host (the reference's declines and the COO cell index),
    upload, densify (scatter into the [P, V] int32 matrix), kernel,
    download."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    host, t_host = timed(lambda: engine.dense_inputs(phi, child, msg), dev)
    P, V, flat, vals, m = host
    up, t_up = timed(lambda: engine._uploads(
        dev, (flat, np.int64), (vals, np.int32), (m, np.int32)), dev)
    dense, t_dense = timed(lambda: engine.densify(P, V, up[0], up[1]), dev)
    out, t_kernel = timed(lambda: ops.dense_message(dense, up[2].view(V, 1)),
                          dev)
    _, t_down = timed(lambda: out.cpu().numpy(), dev)
    return dict(host=t_host, upload=t_up, densify=t_dense, kernel=t_kernel,
                download=t_down)


def run_dense_and_api(cat, queries, a1, a2, dev, tracers) -> dict:
    """Phase 7: the join sizes of phases 4-5 through the dense kernel, the
    single-column expansion over lastfm_A1's widest level, and a second
    desummarize on memoized bounds."""
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import expand_gather_ref
    from repro_torch.obs.trace import Tracer
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import numpy_message
    tr = Tracer()
    tracers.append(tr)
    (phi12, m_ua), t_phi = timed(
        lambda: friends_potential(cat, "U1", "U2"), dev)
    phi23, _ = friends_potential(cat, "U2", "U3")
    P = phi12.sizes[0]
    print(f"dense message path: Phi(U1, U2) {P} x {phi12.sizes[1]} "
          f"({phi12.num_entries} cells) built in {t_phi:.4f}s")

    def message(phi, child, msg, what):
        with tr.span(f"message:{what}"):
            out, t = timed(lambda: engine.maybe_dense_message(
                phi, child, msg, device=dev), dev)
        check(out is not None, f"{what}: maybe_dense_message declined")
        want = numpy_message(phi, child, msg)
        check(out.dtype == np.int64 and np.array_equal(out, want),
              f"{what}: differs from the numpy route")
        return out, t

    m1, t_a1 = message(phi12, "U2", m_ua, "A1 m(U1)")
    size_a1 = int(m1 @ m_ua)
    check(size_a1 == a1["rows"], f"lastfm_A1 by messages {size_a1} vs "
          f"{a1['rows']}")
    m2, t_a2a = message(phi23, "U3", m_ua, "A2 m(U2)")
    m12, t_a2b = message(phi12, "U2", m2, "A2 m(U1)")
    size_a2 = int(m12 @ m_ua)
    check(size_a2 == a2["rows"], f"lastfm_A2 by messages {size_a2} vs "
          f"{a2['rows']}")
    print(f"  lastfm_A1 = sum m1 * m_ua = {size_a1} ({t_a1:.4f}s); "
          f"lastfm_A2 = {size_a2} ({t_a2a:.4f}s + {t_a2b:.4f}s); each "
          f"message equal to the numpy route, each sum to phases 4-5")

    gfjs = a1["gfjs"]
    gj = repro_torch.GraphicalJoin(cat, queries["lastfm_A1"], device=dev,
                                   tracer=tr)
    gfjs._launch.clear()            # run() filled the memo already
    first, t_first = timed(lambda: gj.desummarize(gfjs, decode=False), dev)
    entries = dict(gfjs._launch)
    check(sorted(entries) == list(range(len(gfjs.levels))),
          f"memoized levels {sorted(entries)}")
    second, t_second = timed(lambda: gj.desummarize(gfjs, decode=False), dev)
    check(all(gfjs._launch[lv] is e for lv, e in entries.items())
          and len(gfjs._launch) == len(entries),
          "the second desummarize made new launch metadata")
    for v in first:
        check(torch.equal(first[v], second[v]), f"second desummarize {v}")
    del second
    print(f"  desummarize lastfm_A1 after clearing the memo: first "
          f"{t_first:.4f}s (uploads the levels and fills the memo), second "
          f"{t_second:.4f}s (reuses {len(entries)} levels' device codes and "
          f"bounds, {gfjs.aux_nbytes()} B); equal columns")

    li = next(i for i, lv in enumerate(gfjs.levels) if "A2" in lv.vars)
    lvl, total = gfjs.levels[li], gfjs.join_size
    payload = torch.from_numpy(lvl.key_cols["A2"].astype(np.int32)).to(dev)
    meta = ops.gfjs_expand_meta(gfjs, li, dev)
    with tr.span("rle_expand:A2"):
        col, t_col = timed(lambda: ops.rle_expand(payload, None, total,
                                                  meta=meta), dev)
    check(torch.equal(col, first["A2"]), "rle_expand A2 vs expand_many's")
    check(torch.equal(col, expand_gather_ref(payload, meta, total)),
          "rle_expand A2 vs the plain version")
    del col, first
    with tr.span("expand_indices"):
        idx, t_idx = timed(lambda: ops.expand_indices(meta, total), dev)
    runs = torch.arange(lvl.num_runs, dtype=torch.int32, device=dev)
    check(torch.equal(idx, expand_gather_ref(runs, meta, total)),
          "expand_indices vs the plain version")
    del idx
    print(f"  rle_expand of A2 over level {li} ({lvl.num_runs} runs -> "
          f"{total} rows) {t_col:.4f}s, equal to phase 4's column and the "
          f"plain version; expand_indices {t_idx:.4f}s, equal to the plain "
          f"version")
    return dict(join_sizes=dict(lastfm_A1=size_a1, lastfm_A2=size_a2),
                seconds=dict(phi=t_phi, a1=t_a1, a2=[t_a2a, t_a2b],
                             desummarize_first=t_first,
                             desummarize_second=t_second,
                             rle_expand=t_col, expand_indices=t_idx),
                _split_args=(phi12, m_ua))


# -- phase 8: kernels at the paths' shapes -----------------------------------

def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int):
    """Per-call ms of ``reps`` calls of ``fn`` captured in one CUDA graph
    and replayed twice: the card's time without the host's cost of each
    launch (which bounds a per-call loop of kernels shorter than it).
    None, and said so, where the capture fails."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:        # a measurement, not a check
        print(f"  CUDA graph capture failed: {exc}")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (2 * reps)


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}ms"


def beside(before) -> str:
    """A redesigned kernel's time under its previous design, printed beside
    its new one."""
    return "" if before is None else f", previous design {before:.4f}ms"


def shape_inputs(shape, gfjs, dev, seed):
    """The launch's inputs: the real GFJS level for a desummarize launch,
    seeded inputs of the recorded (K, runs, total) for a generation one."""
    k, runs, total = shape["k"], shape["runs"], shape["total"]
    if shape["phase"] == "desummarize" and gfjs is not None:
        lvl = next(lv for lv in gfjs.levels
                   if lv.num_runs == runs and len(lv.vars) == k)
        payloads = torch.from_numpy(np.stack(
            [lvl.key_cols[v] for v in lvl.vars]).astype(np.int32)).to(dev)
        bounds = torch.from_numpy(
            np.cumsum(lvl.freq).astype(np.int32)).to(dev)
        return payloads, bounds
    gen = torch.Generator(device=dev).manual_seed(seed)
    cuts = torch.randint(0, total + 1, (runs - 1,), generator=gen,
                         device=dev, dtype=torch.int64).sort().values
    bounds = torch.cat([cuts, torch.tensor([total], device=dev)]) \
        .to(torch.int32)
    payloads = torch.randint(0, 1 << 30, (k, runs), generator=gen,
                             device=dev, dtype=torch.int32)
    return payloads, bounds


def measure_shape(shape, gfjs, dev, seed) -> dict:
    """One expand_many launch shape: exact against the plain version, then
    timed (CUDA events) beside its HBM bound, the plain version and
    ``repeat_interleave``."""
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.ref import expand_many_ref
    k, runs, total = shape["k"], shape["runs"], shape["total"]
    payloads, bounds = shape_inputs(shape, gfjs, dev, seed)
    want = expand_many_ref(payloads, bounds, total)
    got = expand_many(payloads, bounds, total)
    err = max_abs_err(got, want)
    check(err == 0, f"kernel vs plain at {shape}: {err}")
    del got, want
    counts = torch.diff(bounds.long(), prepend=torch.zeros(
        1, dtype=torch.int64, device=dev))
    reps = 20 if k * total < (1 << 28) else 5
    ms = cuda_ms(lambda: expand_many(payloads, bounds, total), reps)
    # the launches a host can issue faster than the card runs them (a
    # graph holds every output of its calls, so not the large ones)
    graph = graph_ms(lambda: expand_many(payloads, bounds, total), reps) \
        if k * total <= 1 << 24 else None
    plain_ms = cuda_ms(lambda: expand_many_ref(payloads, bounds, total), reps)
    library_ms = cuda_ms(lambda: torch.repeat_interleave(
        payloads, counts, dim=1, output_size=total), reps)
    nbytes = (k * total + k * runs + runs) * 4
    row = dict(shape, max_abs_err=err, ms=ms, graph_ms=graph, plain_ms=plain_ms, library_ms=library_ms,
               bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    row.pop("t0", None)
    print(f"  {shape['query']} {shape['phase']:<11s} K={k} runs={runs} "
          f"total={total}: kernel {ms:.4f}ms ({fmt_ms(graph)} in a CUDA "
          f"graph), bound {row['bound_ms']:.4f}ms "
          f"({row['bound_ms'] / ms:.3f} of bound), plain {plain_ms:.4f}ms, "
          f"repeat_interleave {library_ms:.4f}ms")
    return row


def summary_shapes(tracers) -> dict:
    """(kernel, n, segments or key bytes, dtype) -> launches, from the
    ``kernel:`` spans of phase 6 (empty inputs launch nothing)."""
    shapes: dict = {}
    for tr in tracers:
        for sp in tr.spans:
            a = sp.args
            if sp.name == "kernel:mul_segsum" and a["n"]:
                key = ("mul_segsum", a["n"], a["segments"], a["dtype"])
            elif sp.name == "kernel:run_boundaries" and a["n"]:
                key = ("run_boundaries", a["n"], a["key_bytes"], None)
            else:
                continue
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def measure_summary_shape(key, launches, dev, seed) -> dict:
    """One phase-6 launch shape on seeded inputs: exact against the plain
    version, then timed (CUDA events) beside its HBM bound, the plain
    version and, for mul_segsum, ``index_add_`` on the product."""
    from repro_torch.kernels.mul_segsum import mul_segsum
    from repro_torch.kernels.ref import mul_segsum_ref, run_boundaries_ref
    from repro_torch.kernels.run_boundaries import run_boundaries
    kernel, n, third, dtype = key
    gen = torch.Generator(device=dev).manual_seed(seed)
    reps = 20 if n < (1 << 24) else 10
    if kernel == "mul_segsum":
        s = third
        acc = torch.float64 if dtype == "float64" else torch.int64
        seg = torch.randint(0, s, (n,), generator=gen, device=dev,
                            dtype=torch.int32).sort().values
        # integral values: float sums are exact, so the check is too
        x = torch.randint(-1000, 1000, (n,), generator=gen, device=dev,
                          dtype=torch.int64).to(acc)
        y = torch.randint(0, 9, (n,), generator=gen, device=dev,
                          dtype=torch.int64).to(acc)
        got, want = mul_segsum(seg, x, y, s), mul_segsum_ref(seg, x, y, s)
        fn = lambda: mul_segsum(seg, x, y, s)                # noqa: E731
        plain = lambda: mul_segsum_ref(seg, x, y, s)         # noqa: E731
        library = lambda: torch.zeros(                       # noqa: E731
            s, dtype=acc, device=dev).index_add_(0, seg, x * y)
        nbytes = n * 4 + 2 * n * 8 + s * 8
        label = f"n={n} segments={s} {dtype}"
    else:
        kdt = torch.int32 if third == 4 else torch.int64
        keys = torch.randint(0, max(n // 4, 1), (n,), generator=gen,
                             device=dev, dtype=kdt).sort().values
        got, want = run_boundaries(keys), run_boundaries_ref(keys)
        fn = lambda: run_boundaries(keys)                    # noqa: E731
        plain = lambda: run_boundaries_ref(keys)             # noqa: E731
        library = None
        nbytes = n * (third + 4)
        label = f"n={n} keys int{8 * third}"
    err = float((got - want).abs().max())
    check(err == 0, f"{kernel} vs plain at {label}: {err}")
    del got, want
    ms = cuda_ms(fn, reps)
    plain_ms = cuda_ms(plain, reps)
    library_ms = cuda_ms(library, reps) if library is not None else None
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lib = "n/a" if library_ms is None else f"{library_ms:.4f}ms"
    print(f"  {kernel} {label} (x{launches}): kernel {ms:.4f}ms, bound "
          f"{bound_ms:.4f}ms ({bound_ms / ms:.3f} of bound), plain "
          f"{plain_ms:.4f}ms, library {lib}")
    return dict(kernel=kernel, n=n, third=third, dtype=dtype,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
                bound_ms=bound_ms, bound_by="bytes")


def counts_instr_per_mac() -> float:
    """SASS instructions per 32 x 32 -> 64-bit multiply-add in the counts
    instantiation of dense_message's tiled kernel (``IMAD.WIDE``, signed;
    the unsigned ones compute addresses), from ``cuobjdump -sass`` of the
    built library; 1.0, and said so, where cuobjdump cannot be run."""
    import re
    from repro_torch.kernels import build
    lib = build.load("dense_message")._name
    tool = Path(build._nvcc()).with_name("cuobjdump")
    try:
        sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"  cuobjdump failed ({exc}): taking 1 instruction per "
              f"multiply-add")
        return 1.0
    body = next(f for f in sass.split("Function : ")[1:]
                if "dense_message_kernel" in f.split()[0]
                and "Counts" in f.split()[0])
    n = len(re.findall(r"\bIMAD\.WIDE ", body))
    print(f"  SASS of the counts kernel: {n} IMAD.WIDE for "
          f"{DENSE_MACS_PER_STEP} multiply-adds per unrolled step")
    return n / DENSE_MACS_PER_STEP


def message_rates(dev) -> dict:
    """The counts path's peak: int32 multiply-adds per second (the guide's
    rate per SM x SMs x the card's maximum SM clock from nvidia-smi) and
    the SASS instructions each 64-bit multiply-add takes."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = float(smi.stdout.split()[0]) * 1e6
    return dict(instr_per_mac=counts_instr_per_mac(), sms=sms,
                clock_hz=clock,
                imad_per_s=IMAD_PER_CLOCK_PER_SM * sms * clock)


def message_shapes(tracers) -> dict:
    """(kernel, shape...) -> launches, from phase 7's ``kernel:`` spans."""
    shapes: dict = {}
    for tr in tracers:
        for sp in tr.spans:
            a = sp.args
            if sp.name == "kernel:dense_message" and a["p"] * a["k"]:
                key = ("dense_message", a["p"], a["v"], a["k"], a["dtype"])
            elif sp.name == "kernel:rle_expand" and a["total"]:
                key = ("expand_gather", a["runs"], a["total"], a["dtype"])
            else:
                continue
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def measure_dense_shape(p, v, k, dtype, launches, dev, seed, rates,
                        cold=False) -> dict:
    """dense_message at [p, v] @ [v, k] on seeded counts in [0, 100):
    exact against the plain version, then timed beside its bound (the
    larger of HBM bytes and multiply-adds at the type's rate), the plain
    version and ``torch.matmul`` (TF32 off; for counts, on float64 copies,
    the nearest library call, exact only while sums stay below 2^53).
    Kernel and library are timed per call (CUDA events around a loop of
    calls) and in a CUDA graph, warm (one phi, which L2 holds) and, with
    ``cold``, rotating over copies of phi that together pass twice the
    L2, so each call reads its phi from HBM."""
    from repro_torch.kernels.dense_message import THIN_K, dense_message
    from repro_torch.kernels.ref import dense_message_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.int32 if dtype == "int32" else torch.float32
    phi = torch.randint(0, 100, (p, v), generator=gen, device=dev,
                        dtype=torch.int32).to(dt)
    m = torch.randint(0, 100, (v, k), generator=gen, device=dev,
                      dtype=torch.int32).to(dt)
    got, want = dense_message(phi, m), dense_message_ref(phi, m)
    err = dense_err(got, want)
    check(err == 0, f"dense_message vs plain at [{p},{v}]@[{v},{k}] "
          f"{dtype}: {err}")
    del got, want
    counts = dt == torch.int32
    reps = 20
    ms = cuda_ms(lambda: dense_message(phi, m), reps)
    graph = graph_ms(lambda: dense_message(phi, m), reps)
    plain_ms = cuda_ms(lambda: dense_message_ref(phi, m), reps)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cold_row = None
    try:
        if counts:
            a, b = phi.double(), m.double()
            lib_name = "float64 torch.matmul"
        else:
            a, b = phi, m
            lib_name = "torch.matmul, TF32 off"
        library_ms = cuda_ms(lambda: torch.matmul(a, b), reps)
        library_graph = graph_ms(lambda: torch.matmul(a, b), reps)
        if cold:
            l2 = getattr(torch.cuda.get_device_properties(dev),
                         "L2_cache_size", 0) or L2_BYTES
            copies = -(-2 * l2 // (phi.numel() * phi.element_size())) + 1
            phis = itertools.cycle([phi.clone() for _ in range(copies)])
            kern = lambda: dense_message(next(phis), m)  # noqa: E731
            cold_ms = cuda_ms(kern, 3 * copies)
            cold_graph = graph_ms(kern, 3 * copies)
            libs = itertools.cycle([phi.to(a.dtype, copy=True)
                                    for _ in range(copies)])
            lib = lambda: torch.matmul(next(libs), b)  # noqa: E731
            cold_lib = cuda_ms(lib, 3 * copies)
            cold_lib_graph = graph_ms(lib, 3 * copies)
            del phis, libs
            cold_row = dict(copies=copies, l2_bytes=l2, ms=cold_ms,
                            graph_ms=cold_graph, library_ms=cold_lib,
                            library_graph_ms=cold_lib_graph)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    nbytes = (p * v + v * k) * 4 + p * k * (8 if counts else 4)
    macs = p * v * k
    ops_ms = (macs * rates["instr_per_mac"] / rates["imad_per_s"] if counts
              else 2 * macs / FP32_FLOP_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    label = f"[{p},{v}]@[{v},{k}] {'counts' if counts else 'float32'}"
    path = "thin" if k <= THIN_K else "tiled"
    key = ("dense_message", p, v, k, dtype)
    before = PREVIOUS_MS.get(key)
    print(f"  dense_message {label} (x{launches}, {path} kernel): kernel "
          f"{ms:.4f}ms per call, {fmt_ms(graph)} in a CUDA graph; bound "
          f"{bound_ms:.4f}ms by {bound_by} ({bound_ms / ms:.3f} of bound per "
          f"call; bytes {bytes_ms:.4f}ms, operations {ops_ms:.4f}ms), plain "
          f"{plain_ms:.4f}ms, {lib_name} {library_ms:.4f}ms per call, "
          f"{fmt_ms(library_graph)} in a graph{beside(before)}")
    if cold_row is not None:
        c = cold_row
        share = "" if c["graph_ms"] is None else \
            f" ({bytes_ms / c['graph_ms']:.3f} of the HBM bound)"
        print(f"    cold, over {c['copies']} copies of phi: kernel "
              f"{c['ms']:.4f}ms per call, {fmt_ms(c['graph_ms'])} in a "
              f"graph{share}; {lib_name} {c['library_ms']:.4f}ms per call, "
              f"{fmt_ms(c['library_graph_ms'])} in a graph")
    return dict(kernel="dense_message", shape=[p, v, k], dtype=dtype,
                path=path, launches=launches, max_abs_err=err, ms=ms,
                graph_ms=graph, plain_ms=plain_ms, library_ms=library_ms,
                library_graph_ms=library_graph, library=lib_name,
                bytes=nbytes, macs=macs, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=bound_ms, bound_by=bound_by, cold=cold_row,
                previous_ms=before)


def dense_k_sweep(dev, seed) -> list:
    """The thin kernel against the tiled one at the Last.fm message's phi,
    [1892, 1892] @ [1892, K] counts, K from 1 to 64: exact against each
    other and the plain version, then timed per call and in a CUDA graph.
    The widest K through which the thin kernel is the faster in the graph
    is the crossover that sets THIN_K."""
    from repro_torch.kernels.dense_message import (THIN_K, THIN_MAX_K,
                                                   dense_message)
    from repro_torch.kernels.ref import dense_message_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    phi = torch.randint(0, 100, (1892, 1892), generator=gen, device=dev,
                        dtype=torch.int32)
    rows = []
    for k in (1, 2, 4, 8, 16, 32, 64):
        m = torch.randint(0, 100, (1892, k), generator=gen, device=dev,
                          dtype=torch.int32)
        thin = dense_message(phi, m, _thin_k=THIN_MAX_K)
        check(torch.equal(thin, dense_message(phi, m, _thin_k=0))
              and torch.equal(thin, dense_message_ref(phi, m)),
              f"dense_message K sweep: thin, tiled and plain differ at K={k}")
        row = dict(k=k)
        for path, tk in (("thin", THIN_MAX_K), ("tiled", 0)):
            row[f"{path}_ms"] = cuda_ms(
                lambda: dense_message(phi, m, _thin_k=tk), 20)
            row[f"{path}_graph_ms"] = graph_ms(
                lambda: dense_message(phi, m, _thin_k=tk), 20)
        rows.append(row)
        print(f"  K={k}: thin {row['thin_ms']:.4f}ms per call, "
              f"{fmt_ms(row['thin_graph_ms'])} in a graph; tiled "
              f"{row['tiled_ms']:.4f}ms per call, "
              f"{fmt_ms(row['tiled_graph_ms'])} in a graph")
    cross = 0
    for row in rows:
        t, w = row["thin_graph_ms"], row["tiled_graph_ms"]
        if t is None or w is None:
            t, w = row["thin_ms"], row["tiled_ms"]
        if t >= w:
            break
        cross = row["k"]
    print(f"  the thin kernel is the faster through K={cross}; the wrapper's "
          f"THIN_K = {THIN_K}")
    return rows


def measure_gather_shape(runs, launches, dev, seed, level=None) -> dict:
    """expand_gather over ``level`` (a GFJS level: its A2 codes and bounds)
    or seeded runs of length 1-15 (the reference benchmark's): exact
    against the plain version, then timed beside its HBM bound, the plain
    version and ``repeat_interleave``."""
    from repro_torch.kernels.expand_gather import expand_gather
    from repro_torch.kernels.ref import expand_gather_ref
    if level is not None:
        freqs = torch.from_numpy(level.freq.astype(np.int64)).to(dev)
        payload = torch.from_numpy(
            level.key_cols["A2"].astype(np.int32)).to(dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        freqs = torch.randint(1, 16, (runs,), generator=gen, device=dev)
        payload = torch.randint(0, 1 << 20, (runs,), generator=gen,
                                device=dev, dtype=torch.int32)
    bounds = torch.cumsum(freqs, 0).to(torch.int32)
    total = int(bounds[-1])
    got, want = expand_gather(payload, bounds, total), \
        expand_gather_ref(payload, bounds, total)
    err = max_abs_err(got[None], want[None])
    check(err == 0, f"expand_gather vs plain at runs={runs}: {err}")
    del got, want
    reps = 20
    ms = cuda_ms(lambda: expand_gather(payload, bounds, total), reps)
    plain_ms = cuda_ms(lambda: expand_gather_ref(payload, bounds, total),
                       reps)
    library_ms = cuda_ms(lambda: torch.repeat_interleave(
        payload, freqs, output_size=total), reps)
    nbytes = (total + 2 * runs) * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    before = PREVIOUS_MS[("expand_gather",
                    "benchmark" if level is None else "lastfm_A1")]
    print(f"  expand_gather runs={runs} total={total} (x{launches}): kernel "
          f"{ms:.4f}ms, bound {bound_ms:.4f}ms ({bound_ms / ms:.3f} of "
          f"bound), plain {plain_ms:.4f}ms, repeat_interleave "
          f"{library_ms:.4f}ms{beside(before)}")
    return dict(kernel="expand_gather", runs=runs, total=total,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bytes=nbytes, bound_ms=bound_ms,
                bound_by="bytes", previous_ms=before)


def kernel_row(name, rows, launches, err, source, replaces) -> dict:
    """The kernels-line entry of a kernel timed at phase 6's or 7's shapes:
    sums over its path's distinct launch shapes (one launch of each;
    shapes with no launch on the path, the benchmark's, are left out)."""
    mine = [r for r in rows if r["kernel"] == name and r["launches"]]
    lib = [r["library_ms"] for r in mine]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max([err] + [r["max_abs_err"] for r in rows
                                 if r["kernel"] == name]),
        ms=sum(r["ms"] for r in mine),
        plain_ms=sum(r["plain_ms"] for r in mine),
        bound_ms=sum(r["bound_ms"] for r in mine),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in mine)
        else "operations",
        library_ms=None if None in lib else sum(lib))


# -- phase 9: the serving path ------------------------------------------------

# lastfm_A1's retained incremental state holds the elimination trace, a
# second GFJS and the expansion indices (~2 x 38.3M int64): the default
# 512 MB would drop it, and the refresh would turn into a cold rebuild
SERVICE_STATE_BYTES = 8 << 30
SERVICE_BUDGET = 1 << 30           # service (b): one lastfm_A1 entry fits
RACERS = 8


def gate(svc):
    """Hold ``svc.frame`` (an instance attribute shadowing the method)
    until released: (calls, entered, release)."""
    orig = svc.frame
    calls, entered, release = [], threading.Event(), threading.Event()

    def gated(query, plan=None):
        calls.append(query.name)
        entered.set()
        check(release.wait(600.0), "the gated build was never released")
        return orig(query, plan=plan)
    svc.frame = gated
    return calls, entered, release


def in_threads(fn, n: int) -> list:
    """``fn(i)`` for i < n on n threads at once; the results in order."""
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as exc:     # reported by the check below
            errors.append(exc)
    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    check(not errors, f"threads failed: {errors!r}")
    return out


def freed_bytes(dev, drop) -> int:
    """Device bytes that ``drop()`` hands back to the allocator."""
    gc.collect()
    sync(dev)
    held = torch.cuda.memory_allocated(dev)
    drop()
    gc.collect()
    sync(dev)
    return held - torch.cuda.memory_allocated(dev)


def levels_equal(a, b) -> bool:
    """Two summaries equal level for level: vars, codes and freq."""
    return (a.join_size == b.join_size
            and list(a.column_order) == list(b.column_order)
            and len(a.levels) == len(b.levels)
            and all(la.vars == lb.vars and np.array_equal(la.freq, lb.freq)
                    and all(np.array_equal(la.key_cols[v], lb.key_cols[v])
                            for v in la.vars)
                    for la, lb in zip(a.levels, b.levels)))


def service_answers(svc, frame_of, specs, dev, out, tracers, what):
    """Each (name, service call, frame call) through the service, split
    (host, transfers, card), held against the same frame on the CPU."""
    for name, ask, want_of in specs:
        got, t = split_call(lambda: ask(svc), dev, tracers)
        want, t_cpu = timed(lambda: want_of(frame_of), dev)
        same(got, want, f"{what} {name}")
        t["cpu_wall"] = t_cpu
        out[name] = t
        print(f"  {what} {name}: {fmt_split(t)}; device='cpu' "
              f"{t_cpu:.4f}s; equal")


def run_service_a(lastfm_kw, dev, tracer, spill, out, tracers) -> None:
    """Service (a): incremental, behind a JoinServer."""
    import repro_torch
    from repro_torch.obs.trace import Tracer
    from repro_torch.relational.synth import lastfm_like
    from repro_torch.serve import JoinServer
    from repro_torch.serve.server import lookup_rows
    from repro_torch.summary import JoinService
    from repro_torch.summary.algebra import SummaryFrame
    cat, qs = lastfm_like(**lastfm_kw)
    a1 = qs["lastfm_A1"]
    svc = JoinService(cat, device=dev, incremental=True, spill_dir=spill,
                      max_state_bytes=SERVICE_STATE_BYTES)
    server = JoinServer(svc, tracer=tracer)
    requests = out.setdefault("requests", [])

    def note(name, reply):
        t = reply.timings
        requests.append(dict(service="a", request=name, source=reply.source,
                             seconds=t["service"], server=t["server"]))
        print(f"  (a) {name}: {reply.source} in {t['service']:.4f}s "
              f"(service), {t['server']:.4f}s (server)")
        return reply

    print(f"service (a): JoinServer(JoinService(device={str(dev)!r}, "
          f"incremental=True, max_state_bytes={SERVICE_STATE_BYTES}))")
    # the racers: the leader's build waits until the others are parked
    calls, entered, release = gate(svc)

    def racer(i):
        if i:
            check(entered.wait(600.0), "no racer reached the service")
        return server.frame(a1)

    def watch():
        check(entered.wait(600.0), "no racer reached the service")
        end = time.monotonic() + 600.0
        while sum(fl.waiters for fl in
                  server._flights._flights.values()) < RACERS - 1:
            check(time.monotonic() < end, "the racers never parked")
            time.sleep(0.001)
        release.set()
    both = in_threads(lambda i: watch() if i == RACERS else racer(i),
                      RACERS + 1)
    del svc.frame
    replies = both[:RACERS]
    sources = sorted(r.source for r in replies)
    check(calls == [a1.name], f"{len(calls)} service builds for "
          f"{RACERS} racers")
    check(sources == ["collapsed"] * (RACERS - 1) + ["computed"],
          f"racer sources {sources}")
    lead = next(r for r in replies if r.source == "computed")
    note(f"lastfm_A1 cold, leader of {RACERS} racers", lead)
    waits = [r.timings["server"] for r in replies if r is not lead]
    print(f"  (a) {RACERS - 1} collapsed replies waited {min(waits):.4f}"
          f"-{max(waits):.4f}s")
    backends = {sp.args.get("backend")
                for sp in tracer.find("phase:summarize")}
    check(backends == {"numpy"}, f"traced build summarized on {backends}")
    print(f"  (a) phase:summarize backend={backends.pop()} (traced build: "
          f"numpy generation with its expansion indices); build phases s: "
          + ", ".join(f"{k} {lead.timings[k]:.4f}" for k in
                      ("build_model", "plan", "build_generator",
                       "summarize")))
    out["racers"] = dict(builds=len(calls), sources=sources,
                         leader=lead.timings["service"], waits=waits)
    again = note("lastfm_A1 again", server.frame(a1))
    check(again.source == "memory", f"warm lastfm_A1 came from "
          f"{again.source}")
    frame = again.frame
    cpu = SummaryFrame.of(frame.gfjs, "cpu")
    per_user = cpu.group_by(["U1"], count="count")
    top = per_user["U1"][int(np.argmax(per_user["count"]))]
    where = {"U1": top}
    aggs = out.setdefault("aggregates_a", {})
    service_answers(svc, cpu, [
        ("count", lambda s: s.count(a1), lambda f: f.count()),
        ("sum U2", lambda s: s.sum(a1, "U2"), lambda f: f.sum("U2")),
        ("mean U2", lambda s: s.mean(a1, "U2"), lambda f: f.mean("U2")),
        ("count by A1", lambda s: s.group_by(a1, "A1", count="count"),
         lambda f: f.group_by("A1", count="count")),
        (f"count by A2 where U1={top}",
         lambda s: s.group_by(a1, "A2", where=where, count="count"),
         lambda f: f.filter(where).group_by("A2", count="count"))],
        dev, aggs, tracers, "(a) lastfm_A1")

    users = np.arange(lastfm_kw["n_users"])
    parts = np.array_split(users, RACERS)
    rows, t_lookup = timed(lambda: in_threads(
        lambda i: server.lookup(a1, "U1", parts[i], {"n": "count"}),
        RACERS), dev)
    table = frame.group_by(["U1"], n="count")
    for keys, got in zip(parts, rows):
        check(np.array_equal(got, lookup_rows(table, "U1", ["n"], keys)),
              "lookup rows vs lookup_rows over the frame's group_by")
    st = server.stats()
    out["lookup"] = dict(keys=len(users), seconds=t_lookup,
                         probes=st["probes"], batched=st["batched"],
                         table_recomputes=st["table_recomputes"])
    print(f"  (a) lookup: COUNT per user for all {len(users)} user ids from "
          f"{RACERS} threads in {t_lookup:.4f}s ({st['probes']} vectorized "
          f"lookups, {st['batched']} batched, {st['table_recomputes']} "
          f"table build); equal to lookup_rows over the frame's group_by")

    uf = cat["user_friends"]
    n = round(uf.num_rows / 100)
    hi = lastfm_kw["n_users"] + -(-lastfm_kw["n_users"] // 100)
    rng = np.random.default_rng(lastfm_kw["seed"] + 1)
    u, f = rng.integers(0, hi, n), rng.integers(0, hi, n)
    u[0] = hi - 1                    # at least one new user: U1 grows
    f = np.where(f == u, (f + 1) % hi, f)
    u_size = frame.gfjs.domains["U1"].size
    svc.append("user_friends", {"userID": u, "friendID": f})
    r = note(f"lastfm_A1 after appending {n} user_friends rows (ids < "
             f"{hi})", server.frame(a1))
    check(r.source == "refreshed", f"lastfm_A1 after the append came from "
          f"{r.source}")
    state_bytes = [s.nbytes() for s in svc._states.values()]
    print(f"  (a) refresh {r.timings['refresh']:.4f}s ("
          + ", ".join(f"{k[8:]} {v:g}" for k, v in r.timings.items()
                      if k.startswith("refresh_")) + f"); retained state "
          f"bytes {state_bytes}; U1 domain {u_size} -> "
          f"{r.frame.gfjs.domains['U1'].size}")
    check(r.frame.gfjs.domains["U1"].size > u_size, "no domain grew")
    gj = repro_torch.GraphicalJoin(cat, a1, plan=r.plan, device=dev)
    rebuild, t_rebuild = timed(gj.run, dev)
    check(levels_equal(r.frame.gfjs, rebuild),
          "the refreshed GFJS vs a cold rebuild on the card")
    card = SummaryFrame.of(rebuild, dev)
    for name, fn in (("count", lambda x: x.count()),
                     ("sum U2", lambda x: x.sum("U2")),
                     ("count by A1", lambda x: x.group_by("A1",
                                                          count="count"))):
        same(fn(r.frame), fn(card), f"refreshed {name}")
    up = Tracer()
    with up.span("desummarize"):
        got, t_memo_free = timed(
            lambda: gj.desummarize(r.frame.gfjs, decode=False), dev)
    want = gj.desummarize(rebuild, decode=False)
    check(all(torch.equal(got[v], want[v]) for v in want),
          "desummarize of the refreshed GFJS vs the rebuild's")
    ups = up.find("engine:upload")
    out["refresh"] = dict(
        rows=n, seconds=r.timings["refresh"], service=r.timings["service"],
        report={k: v for k, v in r.timings.items()
                if k.startswith("refresh_")},
        state_bytes=state_bytes, rebuild_seconds=t_rebuild,
        desummarize_seconds=t_memo_free,
        upload_bytes=sum(s.args.get("bytes", 0) for s in ups))
    print(f"  (a) refreshed GFJS equal level for level to a cold rebuild "
          f"on the card ({t_rebuild:.4f}s), COUNT / SUM / GROUP BY equal; "
          f"its desummarize on the card {t_memo_free:.4f}s uploads "
          f"{out['refresh']['upload_bytes']} B in {len(ups)} spans, equal "
          f"to the rebuild's columns")
    del got, want
    out["stats_a"] = svc.stats()
    print(f"  (a) stats {out['stats_a']}")


def run_service_b(lastfm_kw, dev, tracer, spill, out, tracers) -> None:
    """Service (b): untraced builds on the card, a 1 GiB budget."""
    import repro_torch
    from repro_torch.relational.synth import lastfm_like
    from repro_torch.summary import JoinService
    from repro_torch.summary.algebra import SummaryFrame
    cat, qs = lastfm_like(**lastfm_kw)
    a1, a2 = qs["lastfm_A1"], qs["lastfm_A2"]
    svc = JoinService(cat, device=dev, incremental=False,
                      byte_budget=SERVICE_BUDGET, spill_dir=spill)
    requests = out.setdefault("requests", [])

    def ask(name, q, plan=None):
        with tracer.span("smoke:request", request=name):
            reply = svc.frame(q, plan=plan)
        requests.append(dict(service="b", request=name, source=reply.source,
                             seconds=reply.timings["service"]))
        print(f"  (b) {name}: {reply.source} in "
              f"{reply.timings['service']:.4f}s")
        return reply

    def answers(frame):
        return [frame.count(), frame.sum("A2"),
                frame.group_by("U1", count="count")]

    print(f"service (b): JoinService(device={str(dev)!r}, incremental=False,"
          f" byte_budget={SERVICE_BUDGET})")
    r1 = ask("lastfm_A1, cost plan", a1)
    check(r1.source == "computed" and bool(r1.frame.gfjs._launch),
          "lastfm_A1 was not built on the card")
    aux1 = r1.frame.gfjs.aux_nbytes()
    want1 = answers(r1.frame)
    swap = {"A1": "A2", "A2": "A1", "U1": "U2", "U2": "U1"}
    forced = repro_torch.GraphicalJoin(
        cat, a1, elimination_order=[swap[v] for v in r1.plan.order],
        device=dev).plan()
    check(forced.signature() != r1.plan.signature(), "one plan twice")
    r2 = ask(f"lastfm_A1, forced order {list(forced.order)}", a1, forced)
    st = svc.stats()
    check(r2.source == "computed" and st["evictions"] == 1
          and st["spills"] == 1, f"the second plan did not evict the first "
          f"to disk: {st}")
    path = Path(spill) / f"{r1.key}.gfjs"
    check(path.exists(), "no spill file for the evicted entry")
    spills = tracer.find("cache:spill")
    holder = [r1]
    del r1
    fell = freed_bytes(dev, holder.clear)
    check(fell >= aux1, f"dropping the evicted entry's last reply freed "
          f"{fell} B of its {aux1} B memo")
    out["eviction"] = dict(aux_nbytes=aux1, freed=fell,
                           spill_bytes=path.stat().st_size,
                           spill_seconds=spills[-1].seconds)
    print(f"  (b) evicted lastfm_A1 (cost plan): spill {path.stat().st_size}"
          f" B in {spills[-1].seconds:.4f}s; once no reply held it, "
          f"memory_allocated fell {fell} B (its memo: aux_nbytes {aux1})")
    r3 = ask("lastfm_A1, cost plan again", a1)
    check(r3.source == "disk", f"the evicted entry came from {r3.source}")
    check(not r3.frame.gfjs._launch, "a loaded GFJS holds a memo")
    for name, got, want in zip(("count", "sum A2", "count by U1"),
                               answers(r3.frame), want1):
        same(got, want, f"lastfm_A1 from disk: {name}")
    print("  (b) answers from the disk copy equal the first build's")
    del r2, r3

    r4 = ask("lastfm_A2", a2)
    check(r4.source == "computed" and bool(r4.frame.gfjs._launch),
          "lastfm_A2 was not built on the card")
    r5 = ask("lastfm_A2 again", a2)
    check(r5.source == "memory", f"warm lastfm_A2 came from {r5.source}")
    first = r4.frame.gfjs
    aux2 = first.aux_nbytes()
    cpu2 = SummaryFrame.of(first, "cpu")
    aggs = out.setdefault("aggregates_b", {})
    service_answers(svc, cpu2, [
        ("count", lambda s: s.count(a2), lambda f: f.count()),
        ("count by A2", lambda s: s.group_by(a2, "A2", count="count"),
         lambda f: f.group_by("A2", count="count"))],
        dev, aggs, tracers, "(b) lastfm_A2")
    del r4, r5, cpu2
    print(f"  (b) lastfm_A2 resident: resident_nbytes "
          f"{first.resident_nbytes()}, aux_nbytes {aux2}")
    before = svc.stats()
    probes = len(tracer.find("msg"))
    svc.cache.clear()
    r6 = ask("lastfm_A2 after cache.clear()", a2)
    check(r6.source == "computed", f"the rebuild came from {r6.source}")
    after = svc.stats()
    hits = {k: after[k] - before[k] for k in
            ("msgcache_hits", "msgcache_disk_hits", "msgcache_misses")}
    msg = tracer.find("msg")[probes:]
    hit_spans = sum(bool(s.args.get("hit")) for s in msg)
    check(hits["msgcache_hits"] + hits["msgcache_disk_hits"] > 0
          and hit_spans > 0, f"the rebuild reused no message: {hits}")
    check(levels_equal(r6.frame.gfjs, first),
          "the rebuild's GFJS vs the first lastfm_A2 build")
    del first
    out["msgcache"] = dict(hits, hit_spans=hit_spans, probes=len(msg),
                           rebuild=r6.timings["service"])
    print(f"  (b) rebuild: message cache {hits}, {hit_spans} of {len(msg)} "
          f"msg: spans hits; GFJS identical to the first build")
    aux2 = r6.frame.gfjs.aux_nbytes()
    holder = [r6]
    del r6
    holder.clear()
    fell = freed_bytes(dev, lambda: svc.invalidate("user_friends"))
    check(fell >= aux2, f"invalidate freed {fell} B of lastfm_A2's {aux2} "
          f"B memo")
    out["invalidate"] = dict(aux_nbytes=aux2, freed=fell)
    print(f"  (b) invalidate('user_friends'): memory_allocated fell {fell} B"
          f" (lastfm_A2's memo: aux_nbytes {aux2})")
    out["stats_b"] = svc.stats()
    out["spill_dir_bytes"] = sum(p.stat().st_size
                                 for p in Path(spill).rglob("*")
                                 if p.is_file())
    print(f"  (b) stats {out['stats_b']}; spill directory "
          f"{out['spill_dir_bytes']} B")


def run_service(lastfm_kw, dev) -> dict:
    """Phase 9: the serving path on the card, under one tracer."""
    import tempfile
    from repro_torch.obs import check as trace_check
    from repro_torch.obs.trace import Tracer
    out: dict = {}
    tracers: list = []
    tracer = Tracer()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_service_a(lastfm_kw, dev, tracer, str(Path(tmp) / "a"), out,
                      tracers)
        run_service_b(lastfm_kw, dev, tracer, str(Path(tmp) / "b"), out,
                      tracers)
    doc = tracer.to_chrome_trace()
    errs = trace_check.validate(doc, expect_server=True,
                                expect_msgcache=True)
    check(not errs, f"the service trace: {errs}")
    out["trace_spans"] = len(doc["traceEvents"])
    out["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(f"  the trace ({out['trace_spans']} events) passes "
          f"obs.check.validate(expect_server=True, expect_msgcache=True); "
          f"phase {out['seconds']:.1f}s, peak device bytes "
          f"{out.get('peak_device_bytes')}")
    return out


# -- phase 10: partitioned builds ---------------------------------------------

PARTITIONS = 4


def packed_sorted(cols: dict, sizes: dict) -> torch.Tensor:
    """The rows of ``cols`` as one multiset: each row packed into one
    int64 key (mixed radix over the domain sizes), sorted on the card."""
    check(np.prod([float(n) for n in sizes.values()]) < 2.0 ** 63,
          "rows do not pack into one int64 key")
    key = None
    for v, n in sizes.items():
        c = cols[v].to(torch.int64)
        key = c if key is None else key * n + c
    return torch.sort(key).values


def fmt_report(rep: dict) -> str:
    return (f"sizes {rep['sizes']}, seconds "
            f"[{', '.join(f'{w:.4f}' for w in rep['seconds'])}], skew "
            f"{rep['skew']:.4f}x, time skew {rep['time_skew']:.4f}x, "
            f"stragglers {[s.shard for s in rep['stragglers']]}, executor "
            f"{rep['executor']} workers={rep['workers']} "
            f"retries={rep['retries']}")


def downloads(tracer, since: int) -> tuple:
    """(bytes, summed seconds, wall seconds from the first start to the
    last end) of the ``engine:download`` spans after the first ``since``:
    summed seconds past the wall mean the shards' downloads overlapped."""
    spans = [s for s in tracer.spans[since:] if s.name == "engine:download"]
    if not spans:
        return 0, 0.0, 0.0
    return (sum(s.args.get("bytes", 0) for s in spans),
            sum(s.seconds for s in spans),
            max(s.t1 for s in spans) - min(s.t0 for s in spans))


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def run_part_a1(cat, query, mono, answers, dev, tracer, out) -> tuple:
    """(a) lastfm_A1, PARTITIONS shards on the card, thread executor."""
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.dist.partition import (PartitionScheme, hash_partition,
                                            partition_counts,
                                            partition_histogram)
    reset_peak(dev)
    gj = repro_torch.GraphicalJoin(cat, query, partitions=PARTITIONS,
                                   device=dev, tracer=tracer)
    since = len(tracer.spans)
    g, t_run = timed(gj.run, dev)
    down = downloads(tracer, since)
    plan, rep = gj.plan(), gj._executor.shard_report
    peak_run, aux = peak_bytes(dev), g.aux_nbytes()
    check(g.join_size == sum(g.shard_sizes()) == mono.join_size,
          f"lastfm_A1 shard sizes {g.shard_sizes()} vs {mono.join_size}")
    host = repro_torch.GraphicalJoin(
        cat, query, partitions=PARTITIONS,
        partition_var=plan.partition_var,
        partition_fold=plan.partition_fold, generation_backend="numpy",
        device=dev, tracer=tracer)
    gh, t_numpy = timed(host.run, dev)
    check(host.plan().backends["summarize"] == "numpy"
          and len(gh.shards) == len(g.shards), "numpy shards' plan")
    for i, (a, b) in enumerate(zip(g.shards, gh.shards)):
        check(bool(a._launch) and levels_equal(a, b),
              f"lastfm_A1 shard {i} vs numpy generation")
    del gh, host
    cols, t_des = timed(lambda: gj.desummarize(g, decode=False), dev)
    for v, c in cols.items():
        check(c.shape == (g.join_size,) and c.dtype == torch.int32
              and c.device.type == dev.type, f"lastfm_A1 sharded column {v}")
    mono_cols = engine.desummarize(mono, decode=False, device=dev)
    sizes = {v: g.domains[v].size for v in g.column_order}
    check(torch.equal(packed_sorted(cols, sizes),
                      packed_sorted(mono_cols, sizes)),
          "lastfm_A1 sharded rows vs phase 4's as a multiset")
    del cols, mono_cols
    tracers: list = []
    aggs = {}
    for name, args, kw, want in answers:
        if name == "count by U1,A2":
            continue
        got, t = split_aggregate(gj, args, kw, g, dev, tracers)
        same(got, want, f"sharded lastfm_A1 {name}")
        aggs[name] = t
        print(f"  (a) {name}: {fmt_split(t)}; equal to the monolithic "
              f"frame's")
    nshards = plan.partitions * plan.partition_fold
    pvar = plan.partition_var
    col = np.concatenate([c[pvar] for c in gj.enc.encoded_tables
                          if pvar in c])
    hist = partition_histogram(torch.from_numpy(col).to(dev), nshards,
                               device=dev)
    want = np.bincount(hash_partition(col, nshards), minlength=nshards)
    check(hist.device.type == dev.type
          and np.array_equal(hist.cpu().numpy(), want)
          and np.array_equal(want, partition_counts(
              gj.enc, PartitionScheme(pvar, nshards))),
          "partition_histogram on the card vs np.bincount(hash_partition)")
    peak = peak_bytes(dev)
    out.update(summarize=t_run, numpy_summarize=t_numpy, desummarize=t_des,
               timings={k: float(v) for k, v in gj.timings.items()},
               report={k: v for k, v in rep.items() if k != "stragglers"},
               stragglers=[s.shard for s in rep["stragglers"]],
               aux_nbytes=aux, peak_run=peak_run, peak=peak,
               histogram=hist.cpu().tolist(), aggregates=aggs,
               download_bytes=down[0], download_span_s=down[1],
               download_window_s=down[2],
               partition_var=pvar, fold=plan.partition_fold)
    print(f"  (a) lastfm_A1, {PARTITIONS} shards by hash({pvar}) "
          f"x{plan.partition_fold} fold: |Q|={g.join_size} = sum of the "
          f"shards; run {t_run:.4f}s (phases "
          f"{json.dumps(out['timings'])}); the same shards on numpy "
          f"{t_numpy:.4f}s, equal level for level")
    print(f"  (a) shard report: {fmt_report(rep)}")
    print(f"  (a) engine:download spans: {down[0]} B, {down[1]:.4f}s "
          f"summed over the shards in a {down[2]:.4f}s window")
    print(f"  (a) desummarize {t_des:.4f}s, rows equal phase 4's as a "
          f"multiset; after run(): aux_nbytes {aux} (the shards' device "
          f"memos), peak device bytes {peak_run}; in (a) {peak}")
    print(f"  (a) partition_histogram of {pvar}'s {len(col)} codes on the "
          f"card {out['histogram']}, equal to np.bincount(hash_partition)")
    return g, plan


def run_part_a2(cat, query, a2, answers, dev, tracer, out) -> None:
    """(b) lastfm_A2, PARTITIONS shards on the card."""
    import repro_torch
    from repro_torch.core.gfjs import desummarize_range
    reset_peak(dev)
    gj = repro_torch.GraphicalJoin(cat, query, partitions=PARTITIONS,
                                   device=dev, tracer=tracer)
    since = len(tracer.spans)
    g, t_run = timed(gj.run, dev)
    down = downloads(tracer, since)
    rep = gj._executor.shard_report
    peak_run, aux = peak_bytes(dev), g.aux_nbytes()
    check(g.join_size == sum(g.shard_sizes()) == a2["rows"],
          f"lastfm_A2 shard sizes {g.shard_sizes()} vs {a2['rows']}")
    tracers: list = []
    aggs = {}
    for name, args, kw, want in answers:
        if name == "sum A2":
            continue
        got, t = split_aggregate(gj, args, kw, g, dev, tracers)
        same(got, want, f"sharded lastfm_A2 {name}")
        aggs[name] = t
        print(f"  (b) {name}: {fmt_split(t)}; equal to the monolithic "
              f"frame's")
    reset_peak(dev)
    cols, t_des = timed(lambda: gj.desummarize(g, decode=False), dev)
    peak = peak_bytes(dev)
    for v, c in cols.items():
        check(c.shape == (g.join_size,) and c.device.type == dev.type,
              f"lastfm_A2 sharded column {v}")
    lo_shard, windows = 0, 0
    for i, shard in enumerate(g.shards):
        n = shard.join_size
        for lo in sorted({0, n // 2, max(n - 4096, 0)}):
            hi = min(lo + 4096, n)
            if hi <= lo:
                continue
            win = desummarize_range(shard, lo, hi, decode=False)
            for v in win:
                check(np.array_equal(
                    cols[v][lo_shard + lo:lo_shard + hi].cpu().numpy(),
                    win[v]), f"lastfm_A2 shard {i} window [{lo},{hi}) {v}")
            windows += 1
        lo_shard += n
    del cols
    out.update(summarize=t_run, desummarize=t_des,
               timings={k: float(v) for k, v in gj.timings.items()},
               report={k: v for k, v in rep.items() if k != "stragglers"},
               stragglers=[s.shard for s in rep["stragglers"]],
               aux_nbytes=aux, peak_run=peak_run, peak=peak,
               aggregates=aggs, monolithic_run=a2["t_run"],
               download_bytes=down[0], download_span_s=down[1],
               download_window_s=down[2],
               monolithic_desummarize=a2["t_expand"])
    print(f"  (b) lastfm_A2, {PARTITIONS} shards by hash("
          f"{gj.plan().partition_var}): |Q|={g.join_size} = sum of the "
          f"shards; run {t_run:.4f}s (phase 5's monolithic run "
          f"{a2['t_run']:.4f}s; phases {json.dumps(out['timings'])}), "
          f"desummarize {t_des:.4f}s (phase 5's {a2['t_expand']:.4f}s)")
    print(f"  (b) shard report: {fmt_report(rep)}")
    print(f"  (b) engine:download spans: {down[0]} B, {down[1]:.4f}s "
          f"summed over the shards in a {down[2]:.4f}s window (phase 5: "
          f"{a2['run']['download_s']:.4f}s)")
    print(f"  (b) {windows} shard windows equal numpy desummarize_range; "
          f"after run(): aux_nbytes {aux} (the shards' device memos), peak "
          f"device bytes {peak_run} (phase 5's {a2['peak_run']}); in the "
          f"desummarize {peak} (the memos, {g.join_size} x "
          f"{len(g.column_order)} int32 and one shard's level)")


def run_part_process(cat, query, dev, tracer, out) -> None:
    """(c) lastfm_A1, 2 shards built on numpy in spawned workers."""
    import repro_torch
    from repro_torch.dist.actions import shutdown_shared_executor
    gj = repro_torch.GraphicalJoin(cat, query, partitions=2,
                                   shard_executor="process",
                                   generation_backend="numpy", device=dev,
                                   tracer=tracer)
    try:
        g, t_run = timed(gj.run, dev)
    finally:
        shutdown_shared_executor()
    plan, rep = gj.plan(), gj._executor.shard_report
    check(rep["executor"] == "process" and rep["retries"] == 0,
          f"the process executor: {rep['executor']}, {rep['retries']} "
          f"retries")
    thr = repro_torch.GraphicalJoin(cat, query, partitions=2,
                                    partition_var=plan.partition_var,
                                    partition_fold=plan.partition_fold,
                                    device=dev, tracer=tracer)
    gt, t_thr = timed(thr.run, dev)
    check(len(g.shards) == len(gt.shards), "process shard count")
    for i, (a, b) in enumerate(zip(g.shards, gt.shards)):
        check(levels_equal(a, b), f"process shard {i} vs the thread "
              f"executor's")
    out.update(summarize=t_run, thread_summarize=t_thr,
               report={k: v for k, v in rep.items() if k != "stragglers"})
    print(f"  (c) lastfm_A1, 2 shards by hash({plan.partition_var}) on "
          f"numpy in spawned workers (the process executor generates on "
          f"numpy by the reference's rule): run {t_run:.4f}s (spawn "
          f"included), equal level for level to the thread executor's "
          f"card shards ({t_thr:.4f}s)")
    print(f"  (c) shard report: {fmt_report(rep)}")


def run_part_service(cat, query, a1_answers, dev, out) -> None:
    """(d) JoinService(partitions=PARTITIONS) on the card."""
    import repro_torch
    from repro_torch.core.gfjs import ShardedGFJS
    from repro_torch.relational.table import Catalog
    from repro_torch.summary import JoinService
    want = {name: got for name, _, _, got in a1_answers}
    svc = JoinService(Catalog(dict(cat.tables)), partitions=PARTITIONS,
                      device=dev)
    cold = svc.frame(query)
    check(cold.source == "computed"
          and isinstance(cold.frame.gfjs, ShardedGFJS),
          f"cold partitioned request: {cold.source}")
    warm = svc.frame(query)
    check(warm.source == "memory", f"warm request: {warm.source}")
    count, t_count = timed(lambda: svc.count(query), dev)
    same(count, want["count"], "service COUNT")
    by, t_by = timed(lambda: svc.group_by(query, "A1", count="count"), dev)
    same(by, want["count by A1"], "service GROUP BY A1")
    n = cat["user_friends"].num_rows
    users = int(cat["user_friends"]["userID"].max())
    rows = {"userID": np.asarray([0, 5, users + 2], np.int64),
            "friendID": np.asarray([users + 2, 7, 2], np.int64)}
    svc.append("user_friends", rows)
    rebuilt = svc.frame(query)
    check(rebuilt.source == "computed",
          f"after an append: {rebuilt.source}, not a rebuild")
    fresh = repro_torch.GraphicalJoin(svc.catalog, query, device=dev)
    check(rebuilt.frame.count() == fresh.join_size(),
          "the rebuilt partitioned entry's COUNT")
    aux = rebuilt.frame.gfjs.aux_nbytes()
    shard_aux = sum(s.aux_nbytes() for s in rebuilt.frame.gfjs.shards)
    del cold, warm, rebuilt, fresh
    freed = freed_bytes(dev, lambda: svc.invalidate("user_friends"))
    check(aux == shard_aux and freed >= aux,
          f"invalidate freed {freed} B of a {aux} B sharded memo")
    out.update(cold=svc.stats(), count_s=t_count, group_by_s=t_by,
               aux_nbytes=aux, freed=freed, appended_to=n)
    print(f"  (d) JoinService(partitions={PARTITIONS}): computed, memory; "
          f"COUNT {t_count:.4f}s and GROUP BY A1 {t_by:.4f}s equal (a)'s; "
          f"after a 3-row append: computed (a rebuild); invalidate freed "
          f"{freed} B >= the shards' aux_nbytes {aux} B")


def run_partitioned(cat, queries, mono_a1, a2, answers, dev) -> dict:
    """Phase 10: partitioned builds on the card, under one tracer."""
    from repro_torch.obs import check as trace_check
    from repro_torch.obs.trace import Tracer
    out: dict = {"a": {}, "b": {}, "c": {}, "d": {}}
    tracer = Tracer()
    t0 = time.perf_counter()
    g, _ = run_part_a1(cat, queries["lastfm_A1"], mono_a1,
                       answers["lastfm_A1"], dev, tracer, out["a"])
    del g
    gc.collect()
    torch.cuda.empty_cache()
    run_part_a2(cat, queries["lastfm_A2"], a2, answers["lastfm_A2"], dev,
                tracer, out["b"])
    gc.collect()
    torch.cuda.empty_cache()
    run_part_process(cat, queries["lastfm_A1"], dev, tracer, out["c"])
    with tracer.span("service"):
        run_part_service(cat, queries["lastfm_A1"], answers["lastfm_A1"],
                         dev, out["d"])
    doc = tracer.to_chrome_trace()
    errs = trace_check.validate(doc, expect_shards=True)
    check(not errs, f"the partitioned trace: {errs}")
    out["trace_spans"] = len(doc["traceEvents"])
    out["seconds"] = time.perf_counter() - t0
    print(f"  the trace ({out['trace_spans']} events) passes "
          f"obs.check.validate(expect_shards=True); phase "
          f"{out['seconds']:.1f}s")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the per-shape measurements "
                        "(JSON) to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: the port's kernels run on the card",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"FAIL: the repository's src/repro_torch is missing: {exc}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    power = device_line()
    print(power)
    build_kernels()
    kernels = smoke(dev, LASTFM_2K, args.out, dict(device=kind, power=power))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


def smoke(dev, lastfm_kw, out_path, header) -> list:
    """Phases 3-10 on ``dev``; returns the kernels line's entries.  (The
    measurements need the card; a CPU rehearsal at a small ``lastfm_kw``
    replaces ``cuda_ms`` and ``device_seconds``.)"""
    from repro_torch.kernels.dense_message import dense_message
    from repro_torch.kernels.expand_gather import expand_gather
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.mul_segsum import mul_segsum
    from repro_torch.kernels.run_boundaries import run_boundaries
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import Tracer
    from repro_torch.relational.synth import lastfm_like

    err = check_edge_cases(dev)
    seg_err, b_err = check_summary_kernel_cases(dev)
    g_err, d_err = check_message_kernel_cases(dev)

    t0 = time.perf_counter()
    cat, queries = lastfm_like(**lastfm_kw)
    print(f"data: lastfm_like{lastfm_kw} in {time.perf_counter() - t0:.3f}s: "
          f"user_artists {cat['user_artists'].num_rows} rows, user_friends "
          f"{cat['user_friends'].num_rows} rows")
    fallbacks = REGISTRY.counter("engine.numpy_fallbacks")
    tr_a1, tr_a2 = Tracer(), Tracer()
    expand_many.launches = 0
    fb0 = fallbacks.value
    a1 = run_a1(cat, queries["lastfm_A1"], dev, tr_a1)
    a2 = run_a2(cat, queries["lastfm_A2"], dev, tr_a2)
    launches = expand_many.launches
    check(launches > 0, "the main path launched no expand_many kernel")
    check(fallbacks.value == fb0, "numpy fallbacks on the main path")
    shapes_a1 = kernel_shapes(tr_a1, "lastfm_A1")
    shapes_a2 = kernel_shapes(tr_a2, "lastfm_A2")
    print(f"main path: expand_many launches={launches} (lastfm_A1 "
          f"{len(shapes_a1)}, lastfm_A2 {len(shapes_a2)}), numpy fallbacks=0")

    mul_segsum.launches = run_boundaries.launches = 0
    fb1 = fallbacks.value
    tracers: list = []
    answers: dict = {}
    summary = run_summary(cat, queries, a1, a2, dev, tracers, answers)
    summary_launches = {"mul_segsum": mul_segsum.launches,
                        "run_boundaries": run_boundaries.launches}
    for name, n in summary_launches.items():
        check(n > 0, f"the summary path launched no {name} kernel")
    check(fallbacks.value == fb1, "numpy fallbacks on the summary path")
    print(f"summary path: launches {summary_launches}, numpy fallbacks=0")
    del a2["gfjs"]

    expand_gather.launches = dense_message.launches = 0
    dense_message.thin_launches = 0
    fb2 = fallbacks.value
    msg_tracers: list = []
    dense = run_dense_and_api(cat, queries, a1, a2, dev, msg_tracers)
    message_launches = {"expand_gather": expand_gather.launches,
                        "dense_message": dense_message.launches}
    thin_launches = dense_message.thin_launches
    for name, n in message_launches.items():
        check(n > 0, f"the dense message path launched no {name} kernel")
    check(thin_launches == message_launches["dense_message"],
          f"{thin_launches} of the path's {dense_message.launches} "
          f"dense_message launches took the thin kernel")
    check(fallbacks.value == fb2, "numpy fallbacks on the dense message path")
    print(f"dense message path: launches {message_launches} (dense_message: "
          f"{thin_launches} thin), numpy fallbacks=0")
    phi12, m_ua = dense.pop("_split_args")
    dense_split(phi12, "U2", m_ua, dev)            # warm
    dense["split"] = dense_split(phi12, "U2", m_ua, dev)
    print("  one A1 message, steps s: " + ", ".join(
        f"{k} {v:.6f}" for k, v in dense["split"].items()))

    # lastfm_A1's launches for one run() and one desummarize() (the
    # smoke desummarizes twice), plus lastfm_A2's widest generation launch
    seen = set()
    one_run = []
    for sh in shapes_a1:
        key = (sh["phase"], sh["k"], sh["runs"], sh["total"])
        if key not in seen:
            seen.add(key)
            one_run.append(sh)
    widest = max((s for s in shapes_a2 if s["phase"] == "generate"),
                 key=lambda s: s["k"] * s["total"])
    torch.cuda.empty_cache()
    print("expand_many at the main path's shapes (CUDA events):")
    rows = [measure_shape(s, a1["gfjs"], dev, i)
            for i, s in enumerate(one_run)]
    torch.cuda.empty_cache()
    rows.append(measure_shape(widest, None, dev, len(rows)))
    a1_rows = [r for r in rows if r["query"] == "lastfm_A1"]
    total = {key: sum(r[key] for r in a1_rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"  one lastfm_A1 run's {len(a1_rows)} launches: kernel "
          f"{total['ms']:.4f}ms, bound {total['bound_ms']:.4f}ms, plain "
          f"{total['plain_ms']:.4f}ms, repeat_interleave "
          f"{total['library_ms']:.4f}ms"
          f"{beside(PREVIOUS_MS[('expand_many', 'lastfm_A1')])}")
    err = max([err] + [r["max_abs_err"] for r in rows])

    shapes = summary_shapes(tracers)
    torch.cuda.empty_cache()
    print("mul_segsum and run_boundaries at the summary path's shapes "
          "(CUDA events; seeded inputs):")
    summary_rows = [measure_summary_shape(key, n, dev, i)
                    for i, (key, n) in enumerate(sorted(
                        shapes.items(), key=lambda kv: kv[0][:2]))]

    mshapes = message_shapes(msg_tracers)
    rates = message_rates(dev)
    print(f"expand_gather and dense_message at phase 7's shapes and the "
          f"reference benchmark's (CUDA events; int32 multiply-adds at "
          f"{rates['imad_per_s']:.6g}/s over {rates['instr_per_mac']} "
          f"instruction(s) each, FP32 at {FP32_FLOP_PER_S:.3g} FLOP/s, HBM "
          f"at {HBM_BYTES_PER_S:.3g} B/s):")
    torch.cuda.empty_cache()
    message_rows = []
    for i, (key, n) in enumerate(sorted(mshapes.items())):
        if key[0] == "dense_message":
            message_rows.append(measure_dense_shape(
                *key[1:], n, dev, i, rates, cold=True))
        else:
            runs = key[1]
            level = next(lv for lv in a1["gfjs"].levels
                         if lv.num_runs == runs and "A2" in lv.vars)
            message_rows.append(measure_gather_shape(runs, n, dev, i,
                                                     level))
    for j, dtype in enumerate(("float32", "int32")):
        message_rows.append(measure_dense_shape(2048, 2048, 128, dtype, 0,
                                                dev, 100 + j, rates))
    message_rows.append(measure_gather_shape(1_000_000, 0, dev, 102))
    print("dense_message K sweep at [1892, 1892] @ [1892, K] counts, thin "
          "kernel against tiled:")
    k_sweep = dense_k_sweep(dev, 103)

    # the serving phase builds its own; phase 10 desummarizes lastfm_A1
    # again from its levels (its device memo goes now)
    mono_a1 = memo_free_copy(a1.pop("gfjs"))
    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb3 = fallbacks.value
    service = run_service(lastfm_kw, dev)
    service["launches"] = {"expand_many": expand_many.launches,
                           "mul_segsum": mul_segsum.launches,
                           "run_boundaries": run_boundaries.launches}
    for name, n in service["launches"].items():
        check(n > 0, f"the serving path launched no {name} kernel")
    check(fallbacks.value == fb3, "numpy fallbacks on the serving path")
    print(f"serving path: launches {service['launches']}, numpy "
          f"fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb4 = fallbacks.value
    print("partitioned builds:")
    partitioned = run_partitioned(cat, queries, mono_a1, a2, answers, dev)
    partitioned["launches"] = {"expand_many": expand_many.launches,
                               "mul_segsum": mul_segsum.launches,
                               "run_boundaries": run_boundaries.launches}
    for name, n in partitioned["launches"].items():
        check(n > 0, f"the partitioned path launched no {name} kernel")
    check(fallbacks.value == fb4, "numpy fallbacks on the partitioned path")
    print(f"partitioned path: launches {partitioned['launches']}, numpy "
          f"fallbacks=0")

    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(dict(
            header, shapes=rows,
            summary_shapes=summary_rows, summary=summary,
            lastfm_A1={k: v for k, v in a1.items() if k != "gfjs"},
            lastfm_A2=a2, launches=launches,
            summary_launches=summary_launches, dense=dense,
            message_shapes=message_rows, message_launches=message_launches,
            thin_launches=thin_launches, k_sweep=k_sweep, rates=rates,
            service=service, partitioned=partitioned,
            previous_ms={"/".join(map(str, k)): v
                         for k, v in PREVIOUS_MS.items()}), indent=1))
    kernels = [dict(
        name="expand_many", route="cuda",
        source="src/repro_torch/kernels/csrc/expand_many.cu",
        replaces="src/repro/kernels/expand_fused.py:39",
        launches=launches, max_abs_err=err,
        ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"], bound_by="bytes",
        library_ms=total["library_ms"]),
        kernel_row("mul_segsum", summary_rows,
                   summary_launches["mul_segsum"], seg_err,
                   "src/repro_torch/kernels/csrc/mul_segsum.cu",
                   "src/repro/kernels/segsum.py:29"),
        kernel_row("run_boundaries", summary_rows,
                   summary_launches["run_boundaries"], b_err,
                   "src/repro_torch/kernels/csrc/run_boundaries.cu",
                   "src/repro/kernels/boundaries.py:26"),
        kernel_row("expand_gather", message_rows,
                   message_launches["expand_gather"], g_err,
                   "src/repro_torch/kernels/csrc/expand_many.cu",
                   "src/repro/kernels/expand.py:44"),
        kernel_row("dense_message", message_rows,
                   message_launches["dense_message"], d_err,
                   "src/repro_torch/kernels/csrc/dense_message.cu",
                   "src/repro/kernels/dense_contract.py:29")]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
