"""Multi-pod dry run (``repro/launch/dryrun.py``).

For every (architecture x applicable input shape x mesh) cell, build the
cell's function (``specs.build_cell``: the train step, prefill or
encode, or decode) on the production mesh, 16x16 = 256 ranks single-pod
and (2,16,16) = 512 ranks multi-pod, place its arguments by their
shardings (``specs.place_cell``) and run it once, and record:

  * the per-device bytes of its arguments and outputs (the local shards
    of parameters, optimizer state, batch and caches: whether the cell
    fits a device);
  * the ops that ran on one rank (``launch/op_analysis.py``): FLOPs,
    bytes and collective bytes by kind, for the roofline
    (``launch/roofline.py``).

The reference compiles each cell for 512 host devices and reads XLA's
analyses of the compiled HLO.  The port has no compiler pass to lower:
a fake process group (``torch.testing``'s ``FakeStore``, whose
collectives do nothing) stands for the 256 or 512 ranks, created and
destroyed by :func:`run_cell` itself, and every tensor is on the
``meta`` device (shapes, no storage), so a full-size cell runs on the
host in seconds and allocates nothing.  So there is no HLO file and no
``--reanalyze``: each JSON holds what was counted as the cell ran, and
``seconds`` (the reference's ``seconds_to_compile``) is the time to
build, place and run it.  The reference's ``temp_size_in_bytes`` and the
other compiler figures have no counterpart.

Results land in ``<out>/<arch>--<shape>--<mesh>.json``; a cell that
fails to place or run is written as ``.json.err`` with its traceback, as
the reference does: none is skipped silently.  Those failures are bugs in
the framework, not in the cell.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b \\
      --shape train_4k --mesh single [--preset sp_fsdp] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 skip_reason)
from repro_torch.launch.op_analysis import COLLECTIVE_KINDS, OpCounter

PRESETS = ("default", "sp_fsdp")


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A fake default process group of ``size`` ranks, this process rank
    0, destroyed on exit; raises if a process group is already up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def unit_layers(cfg) -> int:
    """The fewest layers that hold one of each of the family's blocks:
    one unit (gemma3's 5 local + 1 global, zamba2's shared attention and
    6 Mamba2 layers, the vlm's 4 self + 1 cross, xLSTM's mLSTM + sLSTM),
    the moe family's dense layers and one MoE layer, else one layer."""
    if cfg.family == "hybrid":
        return cfg.ssm.attn_every
    if cfg.family == "ssm":
        return 2
    if cfg.family == "moe":
        return cfg.moe.first_dense_layers + 1
    if cfg.family == "vlm":
        return cfg.vlm.cross_attn_every
    if cfg.local_global_pattern:
        return cfg.local_global_pattern + 1
    return 1


def local_bytes(tree) -> int:
    """The bytes one rank holds of every tensor in ``tree`` (nested
    tuples, lists, dicts and dataclasses), each tensor once: a DTensor's
    local shard, a plain tensor whole."""
    import dataclasses
    from repro_torch.dist.act_sharding import is_dtensor
    seen: set = set()
    total = 0

    def walk(node) -> None:
        nonlocal total
        if isinstance(node, torch.Tensor):
            t = node.to_local() if is_dtensor(node) else node
            if id(node) not in seen:
                seen.add(id(node))
                total += t.numel() * t.element_size()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))

    walk(tree)
    return total


def _preset(preset: str, mesh, rules, batch: int):
    """(rules, the activation context) of a preset.

    ``sp_fsdp`` is the reference's: ``SP_FSDP_RULES`` with a (batch, seq
    -> model) constraint on the residual stream.  ``default`` keeps the
    rules given (``arch_rules``) and holds the residual stream to the
    batch's own sharding, over the data axes and whole on the model
    axis, as the reference's GSPMD propagates it from the batch with
    Megatron's layout.  DTensor has no such propagation pass: it picks
    each op's layout alone, and left to itself it reduce-scatters a
    block's pending sum onto the sequence dim, which on the (pod, data,
    model) mesh leaves a strided layout whose every redistribution
    torch 2.13 plans by a graph search (minutes a cell)."""
    from repro_torch.dist.act_sharding import use
    from repro_torch.dist.sharding import SP_FSDP_RULES
    from repro_torch.launch.specs import _batch_axes
    bspec, _ = _batch_axes(mesh, batch)
    if preset == "default":
        return rules, use(mesh, (bspec,))
    if preset != "sp_fsdp":
        raise ValueError(f"unknown preset {preset!r}: {PRESETS}")
    return SP_FSDP_RULES, use(mesh, (bspec, "model"))


def measure(cfg, kind: str, batch: int, seq: int, mesh, *,
            preset: str = "default", rules=None,
            modules: bool = False) -> Tuple[Dict, OpCounter]:
    """Build one cell of ``cfg`` on ``mesh`` (a mesh of the current
    process group), place it and run it once under an
    :class:`OpCounter`: (the reference's result keys, the counter)."""
    from repro_torch.launch import specs
    t0 = time.perf_counter()
    rules, act_ctx = _preset(preset, mesh, rules, batch)
    fn, args, shardings, lm, cfg, kind = specs.cell_of(
        cfg, kind, batch, seq, mesh, rules)
    fn, args = specs.place_cell(lm, kind, args, shardings, seq=seq)
    arg_bytes = local_bytes(args)
    with act_ctx, OpCounter(modules=modules, root=lm) as counter:
        out = fn(*args)
    res = counter.summary()
    coll = {k: res["collectives"][k] for k in COLLECTIVE_KINDS}
    result = {
        "kind": kind,
        "devices": int(mesh.size()),
        "seconds": round(time.perf_counter() - t0, 1),
        "flops": res["flops"],
        "bytes_accessed": res["bytes"],
        "flops_global": res["flops_global"],
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": local_bytes(out)},
        "collectives": {**coll, "total": res["collectives"]["total"],
                        "count": res["collective_count"]},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    return result, counter


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape: str, multi_pod: bool, rules=None,
             overrides: Optional[dict] = None, preset: str = "default",
             *, modules: bool = False, counter: Optional[list] = None
             ) -> Dict:
    """One cell on the production mesh of a fake world of 256 (512
    multi-pod) ranks on meta, which it creates and destroys; returns the
    reference's JSON keys (``seconds`` for ``seconds_to_compile``).
    ``overrides`` scale the config (``num_layers``: the depth); a list
    given as ``counter`` receives the :class:`OpCounter`."""
    from repro_torch.launch.mesh import make_production_mesh
    seq, batch, kind = SHAPES[shape]
    cfg = get_config(arch)
    cfg = cfg.scaled(max_seq=max(cfg.max_seq, seq))
    if overrides:
        cfg = cfg.scaled(**overrides)
    t0 = time.perf_counter()
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        result, c = measure(cfg, kind, batch, seq, mesh, preset=preset,
                            rules=rules, modules=modules)
    if counter is not None:
        counter.append(c)
    result.update(arch=arch, shape=shape, mesh=mesh_name(multi_pod),
                  preset=preset, num_layers=cfg.num_layers,
                  seconds=round(time.perf_counter() - t0, 1))
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--preset", default="default", choices=PRESETS,
                    help="sharding preset (sp_fsdp = context parallel + "
                         "FSDP)")
    ap.add_argument("--suffix", default="",
                    help="suffix for output filenames (variants)")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    total = ok = failed = skipped = 0
    for arch in archs:
        shapes = list(SHAPES) if args.shape == "all" else [args.shape]
        for shape in shapes:
            reason = skip_reason(arch, shape)
            if reason:
                print(f"SKIP  {arch:22s} {shape:12s} -- {reason}",
                      flush=True)
                skipped += 1
                continue
            for mp in meshes:
                total += 1
                name = mesh_name(mp)
                path = os.path.join(
                    args.out, f"{arch}--{shape}--{name}{args.suffix}.json")
                if os.path.exists(path) and not args.force:
                    print(f"CACHED {arch:22s} {shape:12s} {name}",
                          flush=True)
                    ok += 1
                    continue
                try:
                    res = run_cell(arch, shape, mp, preset=args.preset)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    ok += 1
                    print(f"OK    {arch:22s} {shape:12s} {name} "
                          f"seconds={res['seconds']} "
                          f"flops={res['flops']:.3g} "
                          f"coll={res['collectives']['total']:.3g}B",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    failed += 1
                    err = {"arch": arch, "shape": shape, "mesh": name,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    with open(path + ".err", "w") as f:
                        json.dump(err, f, indent=1)
                    print(f"FAIL  {arch:22s} {shape:12s} {name} -- "
                          f"{type(e).__name__}: {str(e)[:200]}", flush=True)
    print(f"\ndry-run: {ok}/{total} ran, {failed} failed, "
          f"{skipped} skipped (documented)", flush=True)


if __name__ == "__main__":
    main()
