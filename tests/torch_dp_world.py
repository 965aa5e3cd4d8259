"""A spawned 4-rank gloo world for ``tests/test_torch_dp.py``.

Imports no jax: each rank imports torch and ``repro_torch`` only.  The
world gets its inputs from files the test writes (the reference's
weights) and from the seeded generators below, which the test calls too,
and writes each rank's results to ``rank<r>.npz``.  :func:`run_world`
runs the ranks through the port's ``run_ranks`` (a deadline, what is left
killed), so a hang fails the test instead of eating the suite's time.
"""

from __future__ import annotations

import datetime
import traceback
from pathlib import Path

import numpy as np

WORLD = 4
DEADLINE_S = 75.0           # the whole world, spawn to join
COLLECTIVE_S = 45           # gloo's own timeout for one collective
# the uncompressed step's AdamW: grad_clip 0 as test_dist.py, but the
# warmup's first step at the full lr (3e-4), not at lr / 100, so that
# Adam's first update (about lr in every element, its sign the reduced
# gradient's) moves the parameters far past the 2e-5 gate
EXACT_OPT = dict(grad_clip=0.0, warmup_steps=1)
LR = 1e-3                   # the compressed steps' AdamW, as test_dist.py
COMPRESSED_STEPS = 5
B, S = 8, 16                # the global batch; rank r takes rows [2r, 2r+2)
# granite-moe's smoke config in bfloat16, as chip_smoke.py's phase 16 (a)
# at a world of 4: its optimizer, steps and seed; 8 x 64 tokens
BF16_ARCH, BF16_STEPS, BF16_SEED, BF16_BS = ("granite_moe_1b_a400m", 3, 16,
                                             (8, 64))
BF16_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
HIST_K = (2, 4, 7)
HIST_SALT = 3


def psum_cases() -> dict:
    """name -> (per-rank gradients [WORLD, ...], residuals or None),
    float32 from one seed."""
    rng = np.random.default_rng(7)
    out = {}
    for shape in ((33, 7), (1,), (4096,)):
        name = "x".join(map(str, shape))
        g = rng.standard_normal((WORLD, *shape)).astype(np.float32)
        out[name] = (g, None)
        r = (rng.standard_normal((WORLD, *shape)) * 1e-2).astype(np.float32)
        out[name + "+residual"] = (g * np.float32(3.0), r)
    out["zero"] = (np.zeros((WORLD, 33, 7), np.float32), None)
    # max |x| = 127 gives scale 1 (1 + 1e-12 rounds to 1 in float32), so
    # every x / scale below is exactly k + 0.5: round half to even
    half = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                     [-3.5, 4.5, 5.5, -6.5, 0.5, 7.5, -8.5, -126.5],
                     [9.5, -10.5, 11.5, 12.5, 13.5, -14.5, 15.5, 16.5],
                     [-0.5, 0.5, -1.5, 1.5, -2.5, 2.5, 100.5, -99.5]],
                    np.float32)
    out["half"] = (half, None)
    return out


def batches(vocab: int) -> list:
    """The uncompressed step's global batch, then COMPRESSED_STEPS more."""
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
            for _ in range(1 + COMPRESSED_STEPS)]


def bf16_batches(vocab: int) -> list:
    rng = np.random.default_rng(BF16_SEED)
    return [{k: rng.integers(0, vocab, BF16_BS).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(BF16_STEPS)]


def rows_of(rank: int, n: int) -> slice:
    b = n // WORLD
    return slice(rank * b, (rank + 1) * b)


def hist_codes() -> dict:
    """name -> (codes, rank cuts): tests/test_dist.py's inputs, cut into
    uneven slices (rank 1's empty)."""
    a = np.random.default_rng(1).integers(0, 10_000, 8191).astype(np.int64)
    b = np.random.default_rng(0).integers(0, 50, 8000).astype(np.int64)
    return {"hash": (a, (0, 3000, 3000, 7100, len(a))),
            "counts": (b, (0, 1, 1, 4000, len(b)))}


def _rank(rank: int, store: str, out: str, weights: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke
    from repro_torch.dist.partition import (partition_histogram,
                                            sharded_potential_counts)
    from repro_torch.interop import lm_state_dict_from_arrays
    from repro_torch.launch.mesh import (make_local_mesh, make_mesh,
                                         make_production_mesh)
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, compressed_psum,
                                   init_train_state, make_dp_shard_map_step)

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    res = {}
    mesh = make_mesh((WORLD,), ("data",), device="cpu")
    group = mesh.get_group("data")

    # the mesh functions
    res["mesh/shape"] = np.asarray(mesh.shape)
    res["mesh/names"] = np.asarray(mesh.mesh_dim_names)
    local = make_local_mesh(model=2, device="cpu")
    res["local/shape"] = np.asarray(local.shape)
    res["local/names"] = np.asarray(local.mesh_dim_names)
    res["local/data_ranks"] = np.asarray(
        dist.get_process_group_ranks(local.get_group("data")))
    res["local1/shape"] = np.asarray(make_local_mesh(device="cpu").shape)
    for name, fn in (("local3", lambda: make_local_mesh(3, device="cpu")),
                     ("production", lambda: make_production_mesh(
                         device="cpu"))):
        try:
            fn()
            res[f"{name}/raised"] = np.asarray("")
        except ValueError as exc:
            res[f"{name}/raised"] = np.asarray(str(exc))

    # compressed_psum on this rank's arrays
    for name, (g, r) in psum_cases().items():
        mean, new_r = compressed_psum(
            torch.from_numpy(g[rank]), group,
            None if r is None else torch.from_numpy(r[rank]))
        res[f"psum/{name}/mean"] = mean.numpy()
        res[f"psum/{name}/residual"] = new_r.numpy()

    # the histograms over this rank's slice
    for name, (codes, cuts) in hist_codes().items():
        part = codes[cuts[rank]:cuts[rank + 1]]
        if name == "hash":
            for k in HIST_K:
                res[f"hist/{name}/{k}"] = partition_histogram(
                    part, k, salt=HIST_SALT, device="cpu",
                    mesh=mesh).numpy()
        else:
            for n in (50, 40):       # 40: codes 40-49 are dropped
                res[f"hist/{name}/{n}"] = sharded_potential_counts(
                    part, n, device="cpu", mesh=mesh).numpy()

    # the data-parallel steps, from the reference's weights
    cfg = get_smoke("qwen3_8b").scaled(num_layers=2, param_dtype="float32",
                                       compute_dtype="float32")
    arrays = dict(np.load(weights))
    data = batches(cfg.vocab)

    def local_batch(b):
        rows = rows_of(rank, B)
        return {k: torch.from_numpy(v[rows]) for k, v in b.items()}

    for compress, opt, steps in ((False, EXACT_OPT, data[:1]),
                                 (True, dict(grad_clip=0.0, lr=LR),
                                  data[1:])):
        lm = LM(cfg, device="cpu")
        lm.load_state_dict(lm_state_dict_from_arrays(cfg, arrays))
        init, step = make_dp_shard_map_step(
            lm, AdamWConfig(**opt), mesh, compress=compress)
        state = init(init_train_state(lm).params)
        tag = "compressed" if compress else "exact"
        for i, b in enumerate(steps):
            state, m = step(state, local_batch(b))
            for k in ("loss", "grad_norm", "lr"):
                res[f"{tag}/{i}/{k}"] = m[k].numpy()
        for n, p in state.params.items():
            res[f"{tag}/params/{n}"] = p.detach().numpy()
        if compress:
            for n, r in state.residual.items():
                res[f"{tag}/residual/{n}"] = r.numpy()

    # granite-moe's smoke config in bfloat16, uncompressed, from a seed
    cfg = get_smoke(BF16_ARCH)
    lm = LM(cfg, device="cpu",
            generator=torch.Generator().manual_seed(BF16_SEED))
    init, step = make_dp_shard_map_step(lm, AdamWConfig(**BF16_OPT), mesh,
                                        compress=False)
    state = init(init_train_state(lm).params)
    for i, b in enumerate(bf16_batches(cfg.vocab)):
        rows = rows_of(rank, BF16_BS[0])
        state, m = step(state, {k: torch.from_numpy(v[rows])
                                for k, v in b.items()})
        res[f"bf16/{i}/grad_norm"] = m["grad_norm"].numpy()
    for n, p in state.params.items():
        res[f"bf16/params/{n}"] = p.detach().float().numpy()
    np.savez(Path(out) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


def _rank_main(rank: int, store: str, out: str, weights: str) -> None:
    try:
        _rank(rank, store, out, weights)
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(out: Path, weights: Path) -> list:
    """Run the world within DEADLINE_S and return each rank's results;
    raises with the ranks' tracebacks if any failed or hung."""
    from repro_torch.launch.ranks import run_ranks
    try:
        run_ranks(_rank_main, WORLD, (str(out / "store"), str(out),
                                      str(weights)), timeout_s=DEADLINE_S)
    except RuntimeError as exc:
        errs = "".join(f.read_text() for f in sorted(out.glob("rank*.err")))
        raise RuntimeError(f"the gloo world failed: {exc}\n{errs}") from exc
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
