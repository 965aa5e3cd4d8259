"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 gjbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (tables from the seed, the program's first query or one request of
each kind, which loads or builds the kernels into ``build/kernels/``),
then a window of ``--seconds`` of closed-loop traffic, then the comparison
with the plain reference.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from the program's spans and
``torch.profiler``.  The last line on standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines on
standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()          # set-up counts from here

import argparse                                            # noqa: E402
import contextlib                                          # noqa: E402
import json                                                # noqa: E402
import subprocess                                          # noqa: E402
import sys                                                 # noqa: E402
from pathlib import Path                                   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name, compared whole,
    is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "power limit not read"


def drive(cell, seed: int, seconds: float, trace: bool, device: str,
          t_start: float = None, sizes: dict = None) -> dict:
    """Set-up, window and comparison of one run; the result's fields.

    ``sizes`` replaces the configuration's sizes (small runs on the CPU).
    """
    import torch
    from gjbench import data as data_mod
    from gjbench.devtrace import Profiler
    from gjbench.load import LOOPS, now, sync
    from gjbench.window import Window

    t_start = now() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = dict(cell.config)
    if sizes:
        cfg["sizes"] = {**cfg["sizes"], **sizes}
    tables = data_mod.generate(cfg, seed)
    tracer = None
    if trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    loop = LOOPS[cell.traffic["loop"]](cfg, cell.traffic, tables, dev, seed,
                                       tracer)
    loop.warm()
    sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = Profiler() if trace and cuda else None
    units = []
    with prof or contextlib.nullcontext():
        setup_s = now() - t_start
        with prof.window() if prof else contextlib.nullcontext():
            t0 = now()
            while now() - t0 < seconds:
                units += loop.round()
            t1 = now()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    spans = [s for s in tracer.spans if t0 <= s.t0 and s.t1 <= t1] \
        if tracer else []
    window = Window(t0, t1, units, setup_s, peak, spans,
                    prof.read(t0) if prof else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(window)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    loop.release()
    checks = loop.checks(window)
    failed = sum(u.failed for u in units)
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": max(setup_peak, peak) if cuda else 0}
    out = {"correct": failed == 0 and all(v <= lim for v, lim
                                          in checks.values()),
           "attempted": len(units), "failed": failed, "metrics": metrics,
           "device": dev_info}
    if window.device is not None:
        dt = window.device
        dev_info.update(busy_s=dt.busy_s, window_s=dt.window_s)
        out["breakdown"] = {"device_ops": dt.device_ops(),
                            "idle_gaps": dt.idle_gaps(spans)}
    out["units"] = units
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def unit_summary(units) -> list:
    """One line per kind of unit: count, failures, seconds min / median /
    max, then the seconds of each in the order they ran."""
    import statistics
    lines = []
    for kind in sorted({u.kind for u in units}):
        s = [u.seconds for u in units if u.kind == kind]
        bad = sum(u.failed for u in units if u.kind == kind)
        lines.append(f"units {kind}: {len(s)} ({bad} failed), s min "
                     f"{min(s):.4f} median {statistics.median(s):.4f} max "
                     f"{max(s):.4f}; in order: "
                     + " ".join(f"{x:.3f}" for x in s))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from gjbench import bench
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from gjbench.roofline import PEAK_NOTE
    print(f"card: {power_line()}; peaks: {PEAK_NOTE}", file=sys.stderr)
    out = drive(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for line in unit_summary(out.pop("units")):
        print(line, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
