"""Abstract input specs and shardings for every (arch x shape x mesh) cell
(``repro/launch/specs.py``).

The reference's ``jax.ShapeDtypeStruct`` stand-ins are tensors on the
``meta`` device here (shapes and dtypes, no storage): ``LM(cfg,
device="meta")`` builds a full-size model that allocates nothing.  Its
``NamedSharding`` is :class:`Sharding`: a torch ``DeviceMesh``, the
DTensor placements on it, and the spec (``repro_torch.dist.sharding``)
they come from.  ``build_cell`` builds the function of each shape kind
(the train step / prefill or encode / decode) on such a model, with its
abstract arguments and their shardings.

:func:`place_params` stands for the reference caller's
``jax.device_put(v, st_sh.params[k])`` loop: it replaces the model's
parameters by DTensors so placed, and ``train_step.make_train_step`` made
afterwards is the sharded step (``init_train_state`` gives moments with
the parameters' placements).  Nothing here is a new training mode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.engine import resolve_device
from repro_torch.dist.act_sharding import is_dtensor
from repro_torch.dist.sharding import (DEFAULT_RULES, ShardingRules, Spec,
                                       mesh_axis_names, param_specs,
                                       placements)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import FRAME_DIM, LM
from repro_torch.train.optim import AdamWConfig, AdamWState
from repro_torch.train.train_step import (TrainState, _check_params,
                                          init_train_state, make_train_step)


class Sharding(NamedTuple):
    """The port's ``NamedSharding``: ``spec`` on ``mesh`` as DTensor
    ``placements``, one per mesh dim."""

    mesh: Any
    placements: tuple
    spec: Spec


def named(mesh, spec: Spec) -> Sharding:
    spec = tuple(spec)
    return Sharding(mesh, placements(spec, mesh), spec)


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh_axis_names(mesh), mesh.shape))


def arch_rules(cfg: ModelConfig, mesh,
               base: ShardingRules = DEFAULT_RULES) -> ShardingRules:
    """Per-arch rule adjustments for divisibility: if heads don't divide the
    model axis, shard head_dim instead (gemma3: 8 heads on a 16-way axis)."""
    model_size = _sizes(mesh).get("model", 1)
    rules = base
    if cfg.num_heads % model_size != 0:
        rules = rules.with_overrides(heads=None, kv_heads=None,
                                     head=("model",))
    elif cfg.num_kv_heads % model_size != 0:
        rules = rules.with_overrides(kv_heads=None)
    return rules


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, batch: int, seq: int,
                 *, labels: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "audio":
        out["frames"] = _meta((batch, seq, FRAME_DIM), torch.float32)
    else:
        out["tokens"] = _meta((batch, seq), torch.int32)
    if labels:
        out["labels"] = _meta((batch, seq), torch.int32)
    if cfg.family == "vlm":
        out["vision"] = _meta(
            (batch, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim),
            torch.float32)
    return out


def _batch_axes(mesh, batch: int):
    """The data axes a batch of ``batch`` rows shards over, and their
    spec entry (None when it does not divide)."""
    sizes = _sizes(mesh)
    baxes = [a for a in ("pod", "data") if a in sizes]
    bsz = 1
    for a in baxes:
        bsz *= sizes[a]
    ok = bool(baxes) and batch % bsz == 0 and batch > 1
    entry = (tuple(baxes) if len(baxes) > 1 else baxes[0]) if ok else None
    return entry, sizes.get("model", 1)


def batch_shardings(cfg: ModelConfig, mesh,
                    batch: int) -> Callable[[torch.Tensor], Sharding]:
    bspec, _ = _batch_axes(mesh, batch)

    def spec_of(t: torch.Tensor) -> Sharding:
        return named(mesh, (bspec,) + (None,) * (t.ndim - 1))

    return spec_of


def cache_shardings(mesh, batch: int
                    ) -> Callable[[torch.Tensor, int], Sharding]:
    """Heuristic cache specs, the reference's: dim 0 of a layer's cache =
    batch (shard over the data axes if divisible), then the largest
    remaining dim sharded over 'model' if divisible.

    ``spec_of(leaf, stacked)`` takes one layer's cache tensor and the
    number of stacks around it (``map_caches`` counts them): the
    reference's leading stacked-layer dims, which the port's per-layer
    caches do not have.  The reference picks among its dims from index 2
    on, so under two stacks (a unit's inner stack) the batch dim is a
    candidate for 'model' and no dim goes to the data axes (the
    reference's dim 1 is then the inner stack's length, which it shards
    only when that length equals ``batch``).  The GQA cache is
    heads-major here (``[B, KV, S, hd]``, the reference's ``[B, S, KV,
    hd]``), so a tie in size between S and KV would break the other way."""
    bspec, model = _batch_axes(mesh, batch)

    def spec_of(leaf: torch.Tensor, stacked: int = 1) -> Sharding:
        shape = tuple(leaf.shape)
        parts: list = [None] * len(shape)
        if stacked + len(shape) >= 3:
            if stacked == 1 and shape[0] == batch and bspec is not None:
                parts[0] = bspec
            # largest remaining dim onto 'model'
            cand = [(shape[i], i) for i in range(max(2 - stacked, 0),
                                                 len(shape))
                    if shape[i] % model == 0 and shape[i] >= model]
            if cand and model > 1:
                _, i = max(cand)
                parts[i] = "model"
        return named(mesh, tuple(parts))

    return spec_of


def map_caches(fn: Callable[[torch.Tensor, int], Any], caches: list):
    """``lm.init_caches``'s structure (a list of segments) with
    ``fn(tensor, stacked)`` in place of every tensor; ``stacked`` counts
    the stacks (lists of layers) around it, the reference's leading
    layer dims.  A :class:`Sharding` counts as a tensor, so the same walk
    reads the shardings ``map_caches`` made.  Non-tensors (a cache's
    ``pos``, MLA's ``v=None``) stay."""

    def walk(node, stacked: int):
        if isinstance(node, list):
            return [walk(c, stacked + 1) for c in node]
        if isinstance(node, (torch.Tensor, Sharding)):
            return fn(node, stacked)
        if isinstance(node, tuple):
            return tuple(walk(c, stacked) for c in node)
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name), stacked)
                for f in dataclasses.fields(node)})
        return node

    return [walk(seg, 0) for seg in caches]


def abstract_state(lm: LM) -> TrainState:
    """The train state of a model built on ``meta``."""
    return init_train_state(lm)


def abstract_caches(lm: LM, batch: int, s_max: int) -> list:
    """The caches of a model built on ``meta`` (meta tensors)."""
    return lm.init_caches(batch, s_max)


def state_shardings(lm: LM, mesh, rules: ShardingRules) -> TrainState:
    """Each parameter's and moment's sharding from the rules; the step
    counter replicated."""
    specs = param_specs(lm.logical_axes(), mesh, rules)
    pshard = {k: named(mesh, s) for k, s in specs.items()}
    return TrainState(pshard, AdamWState(named(mesh, ()), dict(pshard),
                                         dict(pshard)))


def _distribute(t: torch.Tensor, sh: Sharding, *, same: bool = False):
    """``t`` as a DTensor placed by ``sh``: rank 0's values scattered, or
    with ``same`` (a value every rank holds alike, as fresh caches are)
    each rank's own shard of its own copy, with no collective.  A
    DTensor already so placed is returned as it is; a ``"cuda"`` mesh
    without a card raises."""
    from torch.distributed.tensor import distribute_tensor
    if is_dtensor(t):
        if tuple(t.placements) != tuple(sh.placements):
            raise ValueError(f"a DTensor placed {tuple(t.placements)}, "
                             f"not {tuple(sh.placements)}")
        return t
    resolve_device(sh.mesh.device_type)
    return distribute_tensor(t.detach(), sh.mesh, sh.placements,
                             src_data_rank=None if same else 0)


def place_params(lm: LM, shardings: Mapping[str, Sharding]) -> None:
    """Replace each of ``lm``'s parameters, in place, by an
    ``nn.Parameter`` holding ``distribute_tensor(p, mesh, placements)``
    (rank 0's values, as ``distribute_tensor`` scatters them), one
    parameter at a time.  A ``"cuda"`` mesh without a card raises.

    From then on the caches ``lm`` makes (``init_caches``, and so
    ``prefill``) are placed too, by :func:`cache_shardings` on the
    parameters' mesh."""
    mesh = None
    for name in [n for n, _ in lm.named_parameters()]:
        sh = shardings[name]
        mesh = sh.mesh
        path, _, attr = name.rpartition(".")
        mod = lm.get_submodule(path)
        p = mod._parameters[attr]
        placed = _distribute(p, sh)
        mod.register_parameter(attr, nn.Parameter(
            placed, requires_grad=p.requires_grad))
        del p, placed
    lm.cache_placement = functools.partial(_place_new_caches, mesh)


def _place_new_caches(mesh, caches: list, batch: int) -> list:
    return place_caches(caches, map_caches(cache_shardings(mesh, batch),
                                           caches))


def place_caches(caches: list, shardings: list) -> list:
    """``caches`` (``lm.init_caches``'s structure) with each tensor a
    DTensor placed by the :class:`Sharding` at the same place in
    ``shardings`` (``map_caches(cache_shardings(mesh, batch), caches)``).
    Every rank holds the same fresh caches, so each keeps its own shard
    of its own copy: no collective runs."""
    leaves: list = []
    map_caches(lambda sh, k: leaves.append(sh), shardings)
    it = iter(leaves)
    return map_caches(lambda t, k: _distribute(t, next(it), same=True),
                      caches)


def place_cell(lm: LM, kind: str, args: tuple, shardings: tuple, *,
               seq: int, opt_cfg: Optional[AdamWConfig] = None):
    """Place a cell's arguments on the mesh of ``shardings`` and return
    ``(fn, args)``: the cell function made on the placed model and its
    placed arguments.  ``args`` and ``shardings`` are as
    :func:`build_cell` returns them, with meta tensors (the dry run) or
    real ones of the same structure (a model built with weights and a
    real batch).  The parameters are placed in ``lm`` itself
    (:func:`place_params`); the train step and its state are made
    afterwards, so the moments take the parameters' placements; the
    batch, the decode tokens, caches and image context are placed by
    their shardings.  An argument already placed as its sharding says is
    taken as it is."""
    if kind == "train":
        st_sh, b_sh = shardings
        place_params(lm, st_sh.params)
        batch = {k: _distribute(v, b_sh[k]) for k, v in args[1].items()}
        fn = cell_function(lm, kind, seq, opt_cfg)
        return fn, (init_train_state(lm), batch)
    place_params(lm, shardings[0])
    fn = cell_function(lm, kind, seq, opt_cfg)
    params = dict(lm.named_parameters())
    if kind == "prefill":
        b_sh = shardings[1]
        return fn, (params, {k: _distribute(v, b_sh[k])
                             for k, v in args[1].items()})
    out = (params, _distribute(args[1], shardings[1]),
           place_caches(args[2], shardings[2]))
    if len(args) > 3:
        out += (_distribute(args[3], shardings[3]),)
    return fn, out


def _inputs(cfg: ModelConfig, b: Mapping[str, torch.Tensor]):
    return b["frames" if cfg.family == "audio" else "tokens"]


def cell_function(lm: LM, kind: str, seq: int,
                  opt_cfg: Optional[AdamWConfig] = None) -> Callable:
    """The function of one shape kind on ``lm``: the train step
    (``opt_cfg``, AdamW's defaults by default), prefill (or encode, for
    an encoder) to ``seq`` positions, or one decode step.  The port's
    modules hold the parameters, so each takes them, as the reference's
    does, only to check that they are the model's own."""
    cfg = lm.cfg
    if kind == "train":
        return make_train_step(lm, opt_cfg or AdamWConfig())
    if kind == "prefill":
        if lm.encoder_only:
            def fn(params, b):
                _check_params(lm.named_parameters(), params)
                return lm.forward(_inputs(cfg, b), vision=b.get("vision"))
        else:
            def fn(params, b):
                _check_params(lm.named_parameters(), params)
                return lm.prefill(_inputs(cfg, b), seq,
                                  vision=b.get("vision"))
        return fn
    if kind == "decode":
        def fn(params, tokens, caches, vision=None):
            _check_params(lm.named_parameters(), params)
            return lm.decode_step(tokens, caches, vision=vision)
        return fn
    raise ValueError(kind)


def cell_shardings(lm: LM, kind: str, mesh, batch: int, seq: int,
                   rules: ShardingRules) -> tuple:
    """The shardings of a cell's arguments, in :func:`build_cell`'s
    structure: (state, batch) for train, (parameters, batch) for prefill,
    (parameters, tokens, caches[, image context]) for decode."""
    cfg = lm.cfg
    b_of = batch_shardings(cfg, mesh, batch)
    if kind == "train":
        st_sh = state_shardings(lm, mesh, rules)
        return st_sh, {k: b_of(v) for k, v in batch_struct(
            cfg, batch, seq, labels=True).items()}
    p_sh = {k: named(mesh, s)
            for k, s in param_specs(lm.logical_axes(), mesh, rules).items()}
    if kind == "prefill":
        return p_sh, {k: b_of(v) for k, v in batch_struct(
            cfg, batch, seq, labels=False).items()}
    if kind == "decode":
        # the caches' shapes from a model on meta: nothing allocated
        caches = abstract_caches(LM(cfg, device="meta"), batch, seq)
        out = (p_sh, b_of(_meta((batch, 1), torch.int32)),
               map_caches(cache_shardings(mesh, batch), caches))
        if cfg.family == "vlm":
            out += (b_of(_vision_struct(cfg, batch)),)
        return out
    raise ValueError(kind)


def _vision_struct(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return _meta((batch, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim),
                 torch.float32)


def build_cell(arch: str, shape_name: str, mesh,
               rules: Optional[ShardingRules] = None,
               overrides: Optional[dict] = None):
    """Returns (fn, args, in_shardings, lm, cfg, kind) for one grid cell,
    ``lm`` on ``meta``; :func:`place_cell` places them on the mesh."""
    seq, batch, kind = SHAPES[shape_name]
    cfg = get_config(arch)
    cfg = cfg.scaled(max_seq=max(cfg.max_seq, seq))
    if overrides:
        cfg = cfg.scaled(**overrides)
    return cell_of(cfg, kind, batch, seq, mesh, rules)


def cell_of(cfg: ModelConfig, kind: str, batch: int, seq: int, mesh,
            rules: Optional[ShardingRules] = None):
    """:func:`build_cell` for any configuration, kind and size: the
    model on ``meta``, its abstract arguments and their shardings
    (``arch_rules`` by default)."""
    lm = LM(cfg, device="meta")
    rules = rules or arch_rules(cfg, mesh)
    shardings = cell_shardings(lm, kind, mesh, batch, seq, rules)
    fn = cell_function(lm, kind, seq)
    if kind == "train":
        args = (abstract_state(lm), batch_struct(cfg, batch, seq,
                                                 labels=True))
    elif kind == "prefill":
        args = (dict(lm.named_parameters()),
                batch_struct(cfg, batch, seq, labels=False))
    else:
        args = (dict(lm.named_parameters()), _meta((batch, 1), torch.int32),
                abstract_caches(lm, batch, seq))
        if cfg.family == "vlm":
            args += (_vision_struct(cfg, batch),)
    return fn, args, shardings, lm, cfg, kind
