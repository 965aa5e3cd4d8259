"""The control and the program's readings of a cell, seed by seed.

    python3 gjbench/control.py --workload <name> --seeds 11,12,13

For each seed, in one process: the program drives one round of the cell's
traffic at the cell's size and the comparison reads it (the lower
readings); then the control, the plain reference put in the program's
place with one guarantee broken, is read by the same comparison (the upper
readings).  Rows cells: the reference's rows (``reference.rows.expand``)
with one row lost.  Aggregate cells: the reference's answers with counts
accumulated in float32.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, device: str, sizes: dict = None) -> dict:
    """{"program": checks, "control": checks} of one seed."""
    import torch
    from gjbench import data as data_mod
    from gjbench.load import LOOPS, agg_checks, rows_checks, sync
    from gjbench.reference import join, rows
    from gjbench.window import Window

    dev = torch.device(device)
    cfg = dict(cell.config)
    if sizes:
        cfg["sizes"] = {**cfg["sizes"], **sizes}
    data = data_mod.generate(cfg, seed)
    loop = LOOPS[cell.traffic["loop"]](cfg, cell.traffic, data, dev, seed)
    units = loop.round()
    sync(dev)
    loop.release()
    program = loop.checks(Window(0.0, 1.0, units, 0.0))
    if cell.traffic["loop"] == "summary_aggs":
        answers = list(loop.reference(ring="f32").items())
        control = agg_checks(answers, loop.reference())
    else:
        loop.last = None
        tree = loop.tree()
        order = list(dict.fromkeys(v for _, b in loop.query
                                   for v in b.values()))
        cols = rows.expand(tree, order, dev)
        n = int(next(iter(cols.values())).numel())
        lost = {v: c[:n - 1] for v, c in cols.items()}
        del cols
        control = rows_checks(tree, [n - 1], (lost, tree.domains), seed,
                              join.count(tree))
        del lost
    flat = {k: v for k, (v, _) in program.items()}
    return {"seed": seed, "program": flat,
            "control": {k: v for k, (v, _) in control.items()},
            "limits": {k: lim for k, (_, lim) in program.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    from gjbench import bench
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    cell = bench.cell(args.workload)
    for s in args.seeds.split(","):
        r = readings(cell, int(s), "cuda")
        r["workload"] = args.workload
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
