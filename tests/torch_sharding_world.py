"""A spawned 4-rank gloo world for ``tests/test_torch_sharding.py``.

Imports no jax: each rank imports torch and ``repro_torch`` only.  The
world reads the reference's weights from a file the test writes, places
the port's LM on a ``(2, 2)`` ``("data", "model")`` mesh by the sharding
rules, runs one ``make_train_step`` on the placed state and a batch placed
by ``batch_shardings``, and writes each rank's results to ``rank<r>.npz``;
and one rank on a ``(1, 1)`` mesh runs the placed and the plain step
(``one.npz``).
:func:`run_world` runs the ranks through the port's ``run_ranks`` (a
deadline, what is left killed), so a hang fails the test instead of
eating the suite's time.
"""

from __future__ import annotations

import datetime
import traceback
from pathlib import Path

import numpy as np

WORLD = 4
MESH = ((2, 2), ("data", "model"))
DEADLINE_S = 100.0          # the whole world, spawn to join
COLLECTIVE_S = 45           # gloo's own timeout for one collective
# tests/test_dist.py::test_gspmd_sharded_train_step_matches_single_device's
# model and batch; its grad_clip 0, but the warmup's first step at the
# full lr (3e-4), not at lr / 100, so that Adam's first update (about lr
# in every element) moves the parameters far past the 2e-5 gate
SMOKE = dict(num_layers=2, compute_dtype="float32", param_dtype="float32",
             d_model=64, num_heads=4, num_kv_heads=2)
OPT = dict(grad_clip=0.0, warmup_steps=1)
B, S = 8, 16
# the cases: arch_rules over DEFAULT_RULES, alone and under the
# activation constraint of the dry-run's sequence-parallel preset
CASES = ("default", "seq_act")
SEQ_ACT = ("data", "model")         # (batch, seq -> model)


def batch(vocab: int) -> dict:
    """tests/test_dist.py's batch: tokens then labels from one seed."""
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _rank(rank: int, store: str, out: str, weights: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_smoke
    from repro_torch.dist import constrain, use
    from repro_torch.interop import lm_state_dict_from_arrays
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    res = {}
    mesh = make_mesh(*MESH, device="cpu")

    # the activation constraint on values
    x = torch.arange(B * 6, dtype=torch.float32).reshape(B, 6)
    xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    res["act/same"] = np.asarray(constrain(xd) is xd)
    with use(mesh, (None, "model")):
        y = constrain(xd)
    res["act/placements"] = np.asarray(
        [str(p) for p in y.placements])
    res["act/local_shape"] = np.asarray(y.to_local().shape)
    res["act/full"] = y.full_tensor().numpy()

    cfg = get_smoke("qwen3_8b").scaled(**SMOKE)
    state_dict = lm_state_dict_from_arrays(cfg, dict(np.load(weights)))
    b = {k: torch.from_numpy(v) for k, v in batch(cfg.vocab).items()}
    for case in CASES:
        lm = LM(cfg, device="cpu")
        lm.load_state_dict(state_dict)
        rules = specs.arch_rules(cfg, mesh)
        st_sh = specs.state_shardings(lm, mesh, rules)
        specs.place_params(lm, st_sh.params)
        b_of = specs.batch_shardings(cfg, mesh, B)
        placed = {k: distribute_tensor(v, mesh, b_of(v).placements)
                  for k, v in b.items()}
        step = make_train_step(lm, AdamWConfig(**OPT))
        state = init_train_state(lm)
        if case == "seq_act":
            with use(mesh, SEQ_ACT):
                state, m = step(state, placed)
        else:
            state, m = step(state, placed)
        for k in ("loss", "grad_norm", "lr"):
            res[f"{case}/{k}"] = m[k].numpy()
        res[f"{case}/placed_as_rules"] = np.asarray(all(
            tuple(p.placements) == st_sh.params[n].placements
            and tuple(state.opt.m[n].placements) == st_sh.params[n].placements
            and tuple(state.opt.v[n].placements) == st_sh.params[n].placements
            for n, p in state.params.items()))
        res[f"{case}/sharded"] = np.asarray(sum(
            any(not p.is_replicate() for p in t.placements)
            for t in state.params.values()))
        for n, p in state.params.items():
            res[f"{case}/params/{n}"] = p.full_tensor().detach().numpy()
    np.savez(Path(out) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


# one rank, mesh (1, 1): the placed step against the plain one, bit for
# bit, on the dense path and the online attention path (2 x 2 blocks of
# 1,024: the route's limit lowered, so as to take it at S = 2,048)
ONE_SHAPES = ((4, 16), (1, 2048))
ONE_DENSE_LIMIT = 2048 * 1024
ONE_STEPS = 2


def one_batches(vocab: int, B: int, S: int) -> list:
    rng = np.random.default_rng(S)
    return [{k: rng.integers(0, vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(ONE_STEPS)]


def _one_rank(rank: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import flash
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)

    torch.set_num_threads(1)
    flash.DENSE_LIMIT = ONE_DENSE_LIMIT
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    mesh = make_local_mesh(model=1, device="cpu")
    cfg = get_smoke("qwen3_8b").scaled(**SMOKE)
    res = {}
    for B, S in ONE_SHAPES:
        data = [{k: torch.from_numpy(v) for k, v in b.items()}
                for b in one_batches(cfg.vocab, B, S)]
        for placed in (False, True):
            lm = LM(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(S))
            batches = data
            if placed:
                st = specs.state_shardings(lm, mesh,
                                           specs.arch_rules(cfg, mesh))
                specs.place_params(lm, st.params)
                of = specs.batch_shardings(cfg, mesh, B)
                batches = [{k: distribute_tensor(v, mesh, of(v).placements)
                            for k, v in b.items()} for b in data]
            step = make_train_step(lm, AdamWConfig(lr=1e-3, warmup_steps=1))
            state = init_train_state(lm)
            tag = f"{S}/{'placed' if placed else 'plain'}"
            for i, b in enumerate(batches):
                state, m = step(state, b)
                res[f"{tag}/loss{i}"] = m["loss"].numpy()
            for n, p in state.params.items():
                res[f"{tag}/params/{n}"] = (p.full_tensor() if placed
                                            else p).detach().numpy()
    np.savez(Path(out) / "one.npz", **res)
    dist.destroy_process_group()


def _rank_main(rank: int, store: str, out: str, weights: str) -> None:
    try:
        if rank < WORLD:
            _rank(rank, store, out, weights)
        else:
            _one_rank(0, store + "_one", out)
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(out: Path, weights: Path) -> tuple:
    """Run the world and, beside it, the one-rank run, all within
    DEADLINE_S; returns (each rank's results, the one-rank run's); raises
    with the ranks' tracebacks if any failed or hung."""
    from repro_torch.launch.ranks import run_ranks
    try:
        run_ranks(_rank_main, WORLD + 1, (str(out / "store"), str(out),
                                          str(weights)),
                  timeout_s=DEADLINE_S)
    except RuntimeError as exc:
        errs = "".join(f.read_text() for f in sorted(out.glob("rank*.err")))
        raise RuntimeError(f"the gloo world failed: {exc}\n{errs}") from exc
    return ([dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)],
            dict(np.load(out / "one.npz")))

