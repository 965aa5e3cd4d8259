#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

    python3 chip_smoke.py [--out FILE]      # from the repository root

Phases, each fatal on failure (exit code 1, no result line):

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build every kernel of the path from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together) and print ``-Xptxas -v``;
3. each kernel (``expand_many``, ``mul_segsum``, ``run_boundaries``)
   against its plain PyTorch version on small edge cases;
4. ``lastfm_A1`` at Last.fm-2k scale (HetRec 2011: 1,892 users, 17,632
   artists) through ``repro_torch.GraphicalJoin(...).run()`` and
   ``.desummarize()`` on the card, held exactly against the same package's
   numpy generation and numpy desummarization;
5. ``lastfm_A2`` at the same scale, generated and desummarized on the card
   (codes kept on the device), checked by its join size, its column
   lengths and windows against the numpy ``desummarize_range``;
6. the summary side on the card: ``GraphicalJoin.aggregate`` over the
   GFJS of phases 4-5 (COUNT, GROUP BY, SUM, MEAN, a filtered GROUP BY, a
   store -> load -> GROUP BY round trip), each held against the same frame
   on ``device="cpu"`` and split into host, upload and device time; and
   ``engine.build_factor`` (GROUP BY COUNT on the card) over the 38.3M
   desummarized ``(U1, A2)`` rows of lastfm_A1, held against numpy
   ``Factor.from_columns`` and against the summary's GROUP BY;
7. each kernel at the shapes its path gave it (recorded by its ``kernel:``
   spans in phases 4-6): exact against its plain version, and timed with
   CUDA events beside its HBM bound, the plain version and one PyTorch
   call computing the same function where there is one
   (``repeat_interleave``, ``index_add_``);
8. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Kernel launch counts are zeroed just before phase 4 and read just after
phase 5 (``expand_many``: the main path), and zeroed again just before
phase 6 and read just after it (``mul_segsum``, ``run_boundaries``: the
summary path).  ``--out`` writes the per-shape measurements as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
LASTFM_2K = dict(n_users=1892, n_artists=17632, artists_per_user=49,
                 friends_per_user=7, seed=0)


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
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.ref import expand_many_ref
    err = 0
    for name, payloads, freqs in edge_cases():
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
    print(f"edge cases: {len(edge_cases())} exact against the plain version")
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


def run_a1(cat, query, dev, tracer) -> dict:
    """lastfm_A1 on the device, exactly against the numpy path."""
    import repro_torch
    from repro_torch.core.gfjs import desummarize as np_desummarize
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gj = repro_torch.GraphicalJoin(cat, query, device=dev, tracer=tracer)
    gfjs, t_run = timed(gj.run, dev)
    codes, t_expand = timed(lambda: gj.desummarize(gfjs, decode=False), dev)
    host, t_d2h = timed(lambda: {v: c.cpu().numpy()
                                 for v, c in codes.items()}, dev)
    _, t_decode = timed(lambda: {v: gfjs.domains[v].decode(c)
                                 for v, c in host.items()}, dev)
    del codes, host
    values, t_full = timed(lambda: gj.desummarize(gfjs), dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    phases = {k: float(v) for k, v in gj.timings.items()}

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
          f"summarize {ref.timings['summarize']:.4f}s); desummarize "
          f"device expansion {t_expand:.4f}s, D2H {t_d2h:.4f}s, decode "
          f"{t_decode:.4f}s, full decode=True {t_full:.4f}s")
    print(f"  rows/s: device expansion {rows / t_expand:.6g}, "
          f"full {rows / t_full:.6g}; peak device bytes {peak}")
    print(f"  level spans s: {level_seconds(tracer)}")
    print("  exact against the numpy path: GFJS levels and decoded columns")
    return dict(gfjs=gfjs, rows=rows, t_run=t_run, t_expand=t_expand,
                t_d2h=t_d2h, t_decode=t_decode, t_full=t_full, peak=peak,
                phases=phases, t_numpy_run=t_ref,
                numpy_summarize=float(ref.timings["summarize"]))


def run_a2(cat, query, dev, tracer) -> dict:
    """lastfm_A2 on the device; codes stay there; windows vs numpy."""
    import repro_torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gj = repro_torch.GraphicalJoin(cat, query, device=dev, tracer=tracer)
    gfjs, t_run = timed(gj.run, dev)
    codes, t_expand = timed(lambda: gj.desummarize(gfjs, decode=False), dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rows = gfjs.join_size
    check(rows == gj.join_size() == gj.generator.join_size, "join size")
    check(list(codes) == list(gfjs.column_order), "column order")
    for v, c in codes.items():
        check(c.shape == (rows,) and c.device.type == dev.type,
              f"column {v}: {tuple(c.shape)} on {c.device}")
    rng = np.random.default_rng(1)
    starts = [0, rows // 2, max(rows - 4096, 0)] + \
        [int(x) for x in rng.integers(0, max(rows - 4096, 1), 3)]
    for lo in starts:
        hi = min(lo + 4096, rows)
        win = gj.desummarize_range(gfjs, lo, hi, decode=False)
        for v in win:
            check(np.array_equal(codes[v][lo:hi].cpu().numpy(), win[v]),
                  f"window [{lo},{hi}) of {v}")
    print(f"lastfm_A2: |Q|={rows} x {len(codes)} cols, order "
          f"{gj.plan().order}, runs/level "
          f"{[lvl.num_runs for lvl in gfjs.levels]}")
    print(f"  phases s: {json.dumps({k: float(v) for k, v in gj.timings.items()})}")
    print(f"  run {t_run:.4f}s; desummarize device expansion {t_expand:.4f}s "
          f"({rows / t_expand:.6g} rows/s); peak device bytes {peak}")
    print(f"  level spans s: {level_seconds(tracer)}")
    print(f"  {len(starts)} windows exact against numpy desummarize_range")
    return dict(gfjs=gfjs, rows=rows, t_run=t_run, t_expand=t_expand,
                peak=peak,
                phases={k: float(v) for k, v in gj.timings.items()})


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


def split_aggregate(gj, args, kw, gfjs, dev, tracers):
    """One aggregate on the card: (result, seconds split).  ``upload`` and
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
            return gj.aggregate(*args, gfjs=gfjs, **kw)
    out, wall = timed(call, dev)
    up = sum(sp.seconds for sp in tr.find("engine:upload"))
    down = sum(sp.seconds for sp in tr.find("engine:download"))
    kern, copy, ours = device_seconds(
        lambda: gj.aggregate(*args, gfjs=gfjs, **kw), dev)
    return out, dict(wall=wall, upload=up, download=down,
                     host=wall - up - down, kernels=kern, copies=copy,
                     our_launches=ours)


def fmt_split(t: dict) -> str:
    dev = "no device activity recorded" if t["kernels"] is None else \
        (f"{t['kernels']:.6f}s kernels ({t['our_launches']} of ours) + "
         f"{t['copies']:.6f}s copies")
    return (f"{t['wall']:.4f}s = host {t['host']:.4f} + upload "
            f"{t['upload']:.4f} + download/wait {t['download']:.4f}; "
            f"card: {dev}")


def run_summary(cat, queries, a1, a2, dev, tracers) -> dict:
    """Phase 6: aggregates from the GFJS and build_factor on the card."""
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
    for name, args in (("count", ("count",)), ("sum A2", ("sum", "A2"))):
        got, t = split_aggregate(gj2, args, {}, g2, dev, tracers)
        want, t_cpu = timed(lambda: cpu2.aggregate(*args, gfjs=g2), dev)
        same(got, want, f"lastfm_A2 {name}")
        t["cpu_wall"] = t_cpu
        out["lastfm_A2"][name] = t
        print(f"  {name}: {fmt_split(t)}; device='cpu' {t_cpu:.4f}s; equal")
    return out


# -- phase 7: kernels at the paths' shapes -----------------------------------

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
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.ref import expand_many_ref
    k, runs, total = shape["k"], shape["runs"], shape["total"]
    payloads, bounds = shape_inputs(shape, gfjs, dev, seed)
    got = expand_many(payloads, bounds, total)
    want = expand_many_ref(payloads, bounds, total)
    err = max_abs_err(got, want)
    check(err == 0, f"kernel vs plain at {shape}: {err}")
    del got, want
    counts = torch.diff(bounds.long(), prepend=torch.zeros(
        1, dtype=torch.int64, device=dev))
    reps = 20 if k * total < (1 << 28) else 5
    ms = cuda_ms(lambda: expand_many(payloads, bounds, total), reps)
    plain_ms = cuda_ms(lambda: expand_many_ref(payloads, bounds, total), reps)
    library_ms = cuda_ms(lambda: torch.repeat_interleave(
        payloads, counts, dim=1, output_size=total), reps)
    nbytes = (k * total + k * runs + runs) * 4
    row = dict(shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    row.pop("t0", None)
    print(f"  {shape['query']} {shape['phase']:<11s} K={k} runs={runs} "
          f"total={total}: kernel {ms:.4f}ms, bound {row['bound_ms']:.4f}ms "
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
                bound_ms=bound_ms)


def kernel_row(name, rows, launches, err) -> dict:
    """The kernels-line entry of a summary kernel: sums over the distinct
    launch shapes of phase 6 (one launch of each)."""
    mine = [r for r in rows if r["kernel"] == name]
    lib = [r["library_ms"] for r in mine]
    return dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{name}.cu",
        replaces={"mul_segsum": "src/repro/kernels/segsum.py:29",
                  "run_boundaries": "src/repro/kernels/boundaries.py:26"}[
                      name],
        launches=launches,
        max_abs_err=max([err] + [r["max_abs_err"] for r in mine]),
        ms=sum(r["ms"] for r in mine),
        plain_ms=sum(r["plain_ms"] for r in mine),
        bound_ms=sum(r["bound_ms"] for r in mine), bound_by="bytes",
        library_ms=None if None in lib else sum(lib))


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
    """Phases 3-7 on ``dev``; returns the kernels line's entries.  (The
    measurements need the card; a CPU rehearsal at a small ``lastfm_kw``
    replaces ``cuda_ms`` and ``device_seconds``.)"""
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.mul_segsum import mul_segsum
    from repro_torch.kernels.run_boundaries import run_boundaries
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import Tracer
    from repro_torch.relational.synth import lastfm_like

    err = check_edge_cases(dev)
    seg_err, b_err = check_summary_kernel_cases(dev)

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
    summary = run_summary(cat, queries, a1, a2, dev, tracers)
    summary_launches = {"mul_segsum": mul_segsum.launches,
                        "run_boundaries": run_boundaries.launches}
    for name, n in summary_launches.items():
        check(n > 0, f"the summary path launched no {name} kernel")
    check(fallbacks.value == fb1, "numpy fallbacks on the summary path")
    print(f"summary path: launches {summary_launches}, numpy fallbacks=0")
    del a2["gfjs"]

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
          f"{total['library_ms']:.4f}ms")
    err = max([err] + [r["max_abs_err"] for r in rows])

    shapes = summary_shapes(tracers)
    torch.cuda.empty_cache()
    print("mul_segsum and run_boundaries at the summary path's shapes "
          "(CUDA events; seeded inputs):")
    summary_rows = [measure_summary_shape(key, n, dev, i)
                    for i, (key, n) in enumerate(sorted(
                        shapes.items(), key=lambda kv: kv[0][:2]))]

    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(dict(
            header, shapes=rows,
            summary_shapes=summary_rows, summary=summary,
            lastfm_A1={k: v for k, v in a1.items() if k != "gfjs"},
            lastfm_A2=a2, launches=launches,
            summary_launches=summary_launches), indent=1))
    kernels = [dict(
        name="expand_many", route="cuda",
        source="src/repro_torch/kernels/csrc/expand_many.cu",
        replaces="src/repro/kernels/expand_fused.py:39",
        launches=launches, max_abs_err=err,
        ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"], bound_by="bytes",
        library_ms=total["library_ms"]),
        kernel_row("mul_segsum", summary_rows,
                   summary_launches["mul_segsum"], seg_err),
        kernel_row("run_boundaries", summary_rows,
                   summary_launches["run_boundaries"], b_err)]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
