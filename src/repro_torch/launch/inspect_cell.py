"""Diagnose one dry-run cell: its top collectives, or matrix products, by
bytes (``repro/launch/inspect_cell.py``).

  PYTHONPATH=src python -m repro_torch.launch.inspect_cell \\
      --arch starcoder2_3b --shape train_4k [--multi-pod] [--top 15] \\
      [--kinds collectives|dot]

Runs the cell as ``launch/dryrun.py`` does (a fake world of 256 or 512
ranks, meta tensors) under an op counter that records each op with the
innermost module it ran in, forward or backward
(``torch.distributed._tools.mod_tracker.ModTracker``); the module path
stands where the reference prints the jax ``op_name``.  Ops with the same
kind, module and operand shapes are one row: ``count`` is how many ran
(the reference's while amplification ``amp``), ``total`` their bytes.
``dot`` rows are the matrix products (``mm``, ``bmm``, ``addmm``,
``baddbmm``), ranked by the bytes they read and write, with their FLOPs.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch.launch.op_analysis import OpCounter

_DOTS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")


def collect_hot_ops(counter: OpCounter, *, kinds: str = "collectives"
                    ) -> List[Dict]:
    """The counter's records of collectives (``kinds="collectives"``) or
    matrix products (``"dot"``), heaviest first; each with ``total``
    (bytes: operand bytes of a collective, operand and result bytes of a
    product) and ``per`` (one op's)."""
    out = []
    for r in counter.records():
        if kinds == "collectives":
            if r["collective"] is None:
                continue
            total = r["collective_bytes"]
        else:
            if r["kind"] not in _DOTS:
                continue
            total = r["bytes"]
        out.append(dict(r, total=total, per=total / max(r["count"], 1)))
    out.sort(key=lambda d: -d["total"])
    return out


def main() -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--kinds", default="collectives",
                    choices=["collectives", "dot"])
    ap.add_argument("--preset", default="default",
                    choices=["default", "sp_fsdp"])
    args = ap.parse_args()

    get_config(args.arch)                      # an unknown arch fails here
    box: list = []
    run_cell(args.arch, args.shape, args.multi_pod, preset=args.preset,
             modules=True, counter=box)
    rows = collect_hot_ops(box[0], kinds=args.kinds)
    total = sum(r["total"] for r in rows)
    print(f"total {args.kinds} bytes: {total:.3e}")
    for r in rows[:args.top]:
        what = r["collective"] or r["kind"]
        flops = f" flops={r['flops']:.2e}" if args.kinds == "dot" else ""
        print(f"{r['total']:.3e}B  {what:18s} count={r['count']:<6d} "
              f"per={r['per']:.2e}B  {str(r['shapes'])[:40]:40s} "
              f"{r['module'][:90]}{flops}")


if __name__ == "__main__":
    main()
