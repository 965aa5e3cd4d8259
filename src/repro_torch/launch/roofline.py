"""Roofline analysis from the dry run's cells (``repro/launch/roofline.py``).

Per (arch x shape x mesh) cell, compute the three roofline terms:

  compute    = FLOPs            / 989e12 FLOP/s bf16 dense (one H100)
  memory     = bytes            / 3.35e12 B/s HBM3
  collective = collective bytes / 50e9 B/s (one 400 Gb/s NDR port)

plus MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for train cells
(2*N*D for single forward / decode), the usefulness ratio
MODEL_FLOPS / (per-device FLOPs * devices), the dominant term, and a
one-line "what would move it" note.  The dry run's counts
(``launch/dryrun.py``, ``launch/op_analysis.py``) are per device, so the
terms divide by one card's peaks directly.

The peaks are the H100 SXM5 80GB data sheet's, not measurements: dense
bf16 tensor-core FLOP/s and HBM3 bandwidth (PERF.md §3 uses the same
two).  The collective term's link: a 16-way mesh axis spans two 8-GPU
nodes, so its slowest hop is the inter-node one, one 400 Gb/s NDR
InfiniBand port per GPU (a DGX H100's ConnectX-7), 50e9 B/s; NVLink
inside a node is faster.  The dry run's bytes are eager-mode figures
(every elementwise op reads and writes memory, ``op_analysis``), so the
memory term is an upper bound on a fused program's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --dir build/dryrun \\
      [--markdown build/roofline.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

# H100 SXM5 80GB data sheet
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12          # B/s per card, HBM3
# one 400 Gb/s NDR InfiniBand port per GPU (DGX H100): the inter-node hop
# of a 16-way axis over two 8-GPU nodes
LINK_BW = 50e9            # B/s

from repro_torch.configs import SHAPES, get_config


def model_flops(arch: str, shape: str, kind: str) -> float:
    cfg = get_config(arch)
    seq, batch, _ = SHAPES[shape]
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = seq * batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq * batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * batch


def analyze(cell: Dict) -> Dict:
    chips = cell["devices"]
    # the dry run's counts are per device
    flops_dev = max(cell["flops"], 0.0)
    bytes_dev = max(cell["bytes_accessed"], 0.0)
    coll_dev = cell["collectives"]["total"]

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW

    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cell["arch"], cell["shape"], cell["kind"])
    total_flops = flops_dev * chips
    useful = mf / total_flops if total_flops > 0 else 0.0

    bound = max(terms.values())
    # roofline fraction: useful model flops against the peak-compute bound
    # of the *critical* resource time
    frac = (mf / chips / PEAK_FLOPS) / bound if bound > 0 else 0.0

    hints = {
        "compute": "cut non-model FLOPs: remat's recompute (cfg.remat), "
                   "the MoE capacity's padded slots (capacity_factor), "
                   "work the model axis repeats",
        "memory": "fuse elementwise passes into the products' epilogues "
                  "(eager runs each as a pass over memory), keep "
                  "intermediates in bf16, check the remat policy",
        "collective": "re-place to cut all-gathers (FSDP placement of "
                      "the embed dim, tensor parallelism only where the "
                      "weights amortize it), overlap with compute",
    }
    return {
        **{k: cell[k] for k in ("arch", "shape", "mesh", "kind", "devices")},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_total": total_flops,
        "useful_ratio": useful,
        "roofline_fraction": frac,
        "hint": hints[dominant],
        "collective_breakdown": cell["collectives"],
        "memory": cell.get("memory", {}),
    }


def load_cells(directory: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def to_markdown(rows: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "dominant | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--markdown", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    rows = [analyze(c) for c in load_cells(args.dir)]
    md = to_markdown(rows)
    print(md)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md + "\n")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
