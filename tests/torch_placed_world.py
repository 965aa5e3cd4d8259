"""A spawned 4-rank gloo world for ``tests/test_torch_placed_cells.py``.

Imports no jax: each rank imports torch and ``repro_torch`` only.  Each
rank reads the reference's weights of every case from the ``.npz`` files
the test writes, places the port's LM on a ``(2, 2)`` ``("data",
"model")`` mesh (``specs.place_cell``) and runs:

* the train cases: one ``make_train_step`` on the placed state and a
  batch placed by ``batch_shardings`` (the rules of each case);
* the serving cases: a placed prefill and :data:`DECODE` greedy decode
  steps on the placed caches (the image context placed too);
* HuBERT's placed encode;

and writes its results to ``rank<r>.npz``.  Beside the world, one rank
on a ``(1, 1)`` mesh runs every case placed and plain (``one.npz``).
:func:`run_world` runs them through the port's ``run_ranks`` within
:data:`DEADLINE_S`, so a hang fails the test instead of eating the
suite's time.
"""

from __future__ import annotations

import datetime
import traceback
from pathlib import Path

import numpy as np

WORLD = 4
MESH = ((2, 2), ("data", "model"))
DEADLINE_S = 150.0          # the whole world, spawn to join: ~30 s alone,
                            # over 75 s beside the suite's six workers
COLLECTIVE_S = 45           # gloo's own timeout for one collective
F32 = dict(compute_dtype="float32", param_dtype="float32")
# the smoke configs, float32; the train step's first update at the full
# lr with no clipping, so that it moves the parameters far past the gate
LAYERS = {"granite_moe_1b_a400m": 2, "deepseek_v2_236b": 2,
          "zamba2_2p7b": 3, "xlstm_350m": 2, "gemma3_4b": 3,
          "qwen3_8b": 2, "llama32_vision_11b": 2, "hubert_xlarge": 2}
OPT = dict(grad_clip=0.0, warmup_steps=1)
B, S = 8, 16                # the train batch
SB, SS, DECODE = 4, 16, 4   # serving: requests, prompt, greedy steps
# (case, arch, rules): "arch" is arch_rules over DEFAULT_RULES; "sp_fsdp"
# SP_FSDP_RULES with the preset's (batch, seq -> model) constraint
TRAIN = (("granite_moe", "granite_moe_1b_a400m", "arch"),
         ("deepseek_v2", "deepseek_v2_236b", "arch"),
         ("zamba2", "zamba2_2p7b", "arch"),
         ("xlstm", "xlstm_350m", "arch"),
         ("gemma3", "gemma3_4b", "arch"),
         ("llama32_vision", "llama32_vision_11b", "arch"),
         ("hubert", "hubert_xlarge", "arch"),
         ("qwen3_sp_fsdp", "qwen3_8b", "sp_fsdp"))
SERVE = ("qwen3_8b", "granite_moe_1b_a400m", "zamba2_2p7b", "xlstm_350m",
         "llama32_vision_11b")
ENCODE = "hubert_xlarge"
ARCHS = sorted({a for _, a, _ in TRAIN} | set(SERVE) | {ENCODE})


def config(arch: str):
    from repro_torch.configs import get_smoke
    return get_smoke(arch).scaled(num_layers=LAYERS[arch], **F32)


def train_batch(cfg) -> dict:
    """Seeded tokens (frames for audio), labels and image context."""
    rng = np.random.default_rng(0)
    out = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    out.update(inputs(cfg, B, S, rng))
    return out


def inputs(cfg, b: int, s: int, rng) -> dict:
    out = {}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(b, s, 512)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        out["vision"] = rng.normal(size=(b, cfg.vlm.num_image_tokens,
                                         cfg.vlm.vision_dim)).astype(
            np.float32)
    return out


def serve_inputs(cfg) -> dict:
    return inputs(cfg, SB, SS, np.random.default_rng(1))


def _model(arch: str, weights: str):
    import torch
    from repro_torch.interop import lm_state_dict_from_arrays
    from repro_torch.models.model import LM
    cfg = config(arch)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    lm.load_state_dict(lm_state_dict_from_arrays(
        cfg, dict(np.load(Path(weights) / f"{arch}.npz"))))
    return cfg, lm


def _rules(cfg, mesh, which: str):
    from repro_torch.dist.sharding import SP_FSDP_RULES
    from repro_torch.launch import specs
    return SP_FSDP_RULES if which == "sp_fsdp" else specs.arch_rules(
        cfg, mesh)


def _context(mesh, which: str):
    import contextlib
    from repro_torch.dist.act_sharding import use
    return use(mesh, ("data", "model")) if which == "sp_fsdp" \
        else contextlib.nullcontext()


def _full(t):
    from repro_torch.dist.act_sharding import is_dtensor
    return (t.full_tensor() if is_dtensor(t) else t).detach().numpy()


def train_case(arch: str, which: str, weights: str, mesh) -> dict:
    """One train step, placed on ``mesh`` (plain with ``mesh=None``):
    its loss, grad norm and the parameters after it."""
    import torch
    from repro_torch.launch import specs
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train.train_step import make_train_step
    cfg, lm = _model(arch, weights)
    b = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    ocfg = AdamWConfig(**OPT)
    if mesh is None:
        step, state = make_train_step(lm, ocfg), init_train_state(lm)
        state, m = step(state, b)
    else:
        sh = specs.cell_shardings(lm, "train", mesh, B, S,
                                  _rules(cfg, mesh, which))
        step, (state, b) = specs.place_cell(lm, "train", (None, b), sh,
                                            seq=S, opt_cfg=ocfg)
        with _context(mesh, which):
            state, m = step(state, b)
    out = {"loss": m["loss"].numpy(), "grad_norm": _full(m["grad_norm"])}
    out.update({f"params/{n}": _full(p) for n, p in state.params.items()})
    out["sharded"] = np.asarray(sum(
        any(not p.is_replicate() for p in t.placements)
        for t in state.params.values()) if mesh is not None else 0)
    return out


def serve_case(arch: str, weights: str, mesh) -> dict:
    """A prefill of the seeded prompts and DECODE greedy steps (an
    encode for an encoder), placed on ``mesh`` or plain: the tokens and
    each step's last-position logits."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import specs
    cfg, lm = _model(arch, weights)
    x = {k: torch.from_numpy(v) for k, v in serve_inputs(cfg).items()}
    place = (lambda t: t)
    if mesh is not None:
        sh = specs.cell_shardings(lm, "prefill", mesh, SB, SS + DECODE,
                                  specs.arch_rules(cfg, mesh))
        _, (_, x) = specs.place_cell(lm, "prefill", (None, x), sh,
                                     seq=SS + DECODE)
        of = specs.batch_shardings(cfg, mesh, SB)

        def place(t):
            return distribute_tensor(t, mesh, of(t).placements)
    out = {}
    with torch.no_grad():
        if lm.encoder_only:
            out["logits0"] = _full(lm(x["frames"]))
            return out
        vision = x.get("vision")
        logits, caches = lm.prefill(x["tokens"], SS + DECODE, vision=vision)
        toks = []
        for i in range(DECODE):
            last = _full(logits)[:, -1, :cfg.vocab]
            out[f"logits{i}"] = last
            tok = torch.from_numpy(last.argmax(-1).astype(np.int32))[:, None]
            toks.append(tok.numpy())
            logits, caches = lm.decode_step(place(tok), caches,
                                            vision=vision)
        out[f"logits{DECODE}"] = _full(logits)[:, -1, :cfg.vocab]
        out["tokens"] = np.concatenate(toks, axis=1)
        leaves = []
        specs.map_caches(lambda t, k: leaves.append(t), caches)
        from repro_torch.dist.act_sharding import is_dtensor
        out["caches_placed"] = np.asarray(all(map(is_dtensor, leaves))
                                          if mesh is not None else True)
    return out


def run_cases(weights: str, mesh) -> dict:
    res = {}
    for case, arch, which in TRAIN:
        for k, v in train_case(arch, which, weights, mesh).items():
            res[f"train/{case}/{k}"] = v
    for arch in SERVE + (ENCODE,):
        for k, v in serve_case(arch, weights, mesh).items():
            res[f"serve/{arch}/{k}"] = v
    return res


def _init(rank: int, world: int, store: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_S))


def _rank(rank: int, store: str, out: str, weights: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    _init(rank, WORLD, store)
    res = run_cases(weights, make_mesh(*MESH, device="cpu"))
    np.savez(Path(out) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


def _one_rank(store: str, out: str, weights: str) -> None:
    """A (1, 1) mesh: every case placed, then plain."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    _init(0, 1, store)
    mesh = make_local_mesh(model=1, device="cpu")
    res = {f"placed/{k}": v for k, v in run_cases(weights, mesh).items()}
    res.update({f"plain/{k}": v for k, v in run_cases(weights,
                                                       None).items()})
    np.savez(Path(out) / "one.npz", **res)
    dist.destroy_process_group()


def _rank_main(rank: int, store: str, out: str, weights: str) -> None:
    try:
        if rank < WORLD:
            _rank(rank, store, out, weights)
        else:
            _one_rank(store + "_one", out, weights)
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
