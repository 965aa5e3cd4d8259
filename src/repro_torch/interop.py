"""Carry state across from the reference package as numpy arrays and dicts.

The port shares no class with ``repro``: these builders take the plain
arrays a reference catalog or GFJS holds and make the port's own objects,
so the same data can go through both packages.

    cat = catalog_from_arrays({t.name: dict(t.columns)
                               for t in ref_catalog.tables.values()})
    gfjs = gfjs_from_arrays([(lvl.vars, lvl.key_cols, lvl.freq)
                             for lvl in ref_gfjs.levels],
                            ref_gfjs.column_order, ref_gfjs.join_size,
                            {v: d.values for v, d in ref_gfjs.domains.items()})
    lm.load_state_dict(lm_state_dict_from_arrays(
        cfg, {k: np.asarray(v, np.float32) for k, v in ref_params.items()}))
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.gfjs import GFJS, LevelSummary
from repro_torch.core.potentials import INT
from repro_torch.relational.encoding import Domain
from repro_torch.relational.table import Catalog, Table


def catalog_from_arrays(
        tables: Mapping[str, Mapping[str, np.ndarray]]) -> Catalog:
    """``{table: {column: values}}`` -> the port's :class:`Catalog`."""
    return Catalog.of(*(Table(name, dict(cols))
                        for name, cols in tables.items()))


def gfjs_from_arrays(
        levels: Sequence[Tuple[Sequence[str], Mapping[str, np.ndarray],
                               np.ndarray]],
        column_order: Sequence[str], join_size: int,
        domain_values: Mapping[str, np.ndarray]) -> GFJS:
    """Per-level ``(vars, {var: codes per run}, freq)`` -> the port's GFJS.

    ``domain_values`` holds each variable's sorted unique raw values (the
    dictionary its codes index).
    """
    out = []
    for vars_, key_cols, freq in levels:
        vars_ = tuple(vars_)
        freq = np.asarray(freq, dtype=INT)
        cols = {v: np.asarray(key_cols[v], dtype=INT) for v in vars_}
        if any(len(c) != len(freq) for c in cols.values()):
            raise ValueError(f"level {vars_}: code columns and freq differ "
                             "in length")
        out.append(LevelSummary(vars_, cols, freq))
    sizes = {int(lvl.freq.sum()) for lvl in out}
    if sizes - {int(join_size)}:
        raise ValueError(f"level frequencies sum to {sorted(sizes)}, "
                         f"not join_size {join_size}")
    domains: Dict[str, Domain] = {v: Domain(v, np.asarray(vals))
                                  for v, vals in domain_values.items()}
    return GFJS(out, list(column_order), int(join_size), domains)


# -- LM parameters -----------------------------------------------------------
#
# The reference keeps an LM's parameters in one flat dict, each stack's
# stacked on a leading axis under the name of its block; the port keeps
# one module per layer.  The name map, port state-dict key -> (reference
# key, index into it), reads each stack's block name ``P`` from the
# model's ``reference_prefixes`` (``b`` for a transformer block, ``m``
# for Mamba2, ``xm`` for an mLSTM layer, empty for a unit, which names
# its parts itself):
#
#   embed | head | final_norm | vision_norm | frontend_proj
#                                           -> the same name, ()
#   shared.<rest>                           -> shared.shared.<rest>, ()
#                                              (zamba2's shared block)
#   segments.<s>.<i>.<c>.<j>.<rest>         -> <s>.<c>.<P of s.c>.<rest>,
#                                              (i, j) (a unit's inner
#                                              stack: gemma3's loc, b;
#                                              zamba2's mam, m)
#   segments.<s>.<i>.<rest>                 -> <s>.<P of s>.<rest>, (i,)
#
# e.g. ``blocks.b.attn.wq`` [L, d, H, hd] holds layer i's
# ``segments.blocks.<i>.attn.wq`` [d, H, hd], ``units.mam.m.ssm.D``
# [U, k, H] unit i's layer j's ``segments.units.<i>.mam.<j>.ssm.D`` and
# ``units.xs.cell.r`` [U, ...] unit i's ``segments.units.<i>.xs.cell.r``;
# a vlm unit's ``units.sa.b.attn.wq`` [U, k, d, H, hd] and
# ``units.x.attn.wk`` [U, vision_dim, KV, hd] (its cross layer).
# Without the model's prefixes, every stack's is ``b`` and ``units``'s
# empty: the dense, moe, gemma3, vlm and audio families'.  bf16 travels
# as float32 numpy, which holds every bf16 value exactly.

_SEG = re.compile(r"segments\.(\w+)\.(\d+)\.(.*)")
_INNER = re.compile(r"(\w+)\.(\d+)\.(.*)")
DEFAULT_PREFIXES = {"units": ""}


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def lm_reference_name(key: str, prefixes: Optional[Mapping[str, str]] = None
                      ) -> Tuple[str, Tuple[int, ...]]:
    """A port state-dict key -> (reference key, index into it), under a
    model's ``reference_prefixes``."""
    prefixes = DEFAULT_PREFIXES if prefixes is None else prefixes
    m = _SEG.fullmatch(key)
    if m is None:
        top, _, rest = key.partition(".")
        return (_join(top, prefixes[top], rest) if top in prefixes
                else key), ()
    seg, i, rest = m[1], int(m[2]), m[3]
    inner = _INNER.fullmatch(rest)
    if inner is not None:
        c = inner[1]
        return (_join(seg, c, prefixes.get(f"{seg}.{c}", "b"), inner[3]),
                (i, int(inner[2])))
    return _join(seg, prefixes.get(seg, "b"), rest), (i,)


def lm_state_dict_from_arrays(cfg, params: Mapping[str, np.ndarray]
                              ) -> Dict[str, torch.Tensor]:
    """The reference's flat LM parameters (numpy) -> the port's
    ``LM(cfg)`` state dict, on the CPU in ``cfg.param_dtype``."""
    from repro_torch.models.model import LM
    out: Dict[str, torch.Tensor] = {}
    used = set()
    lm = LM(cfg, device="meta")
    for key, meta in lm.state_dict().items():
        ref, idx = lm_reference_name(key, lm.reference_prefixes)
        if ref not in params:
            raise KeyError(f"{key}: no reference parameter {ref!r}")
        a = np.asarray(params[ref], dtype=np.float32)[idx]
        if a.shape != tuple(meta.shape):
            raise ValueError(f"{ref}{list(idx)}: shape {a.shape}, the port's "
                             f"{key} is {tuple(meta.shape)}")
        out[key] = torch.tensor(a).to(meta.dtype)
        used.add(ref)
    if set(params) - used:
        raise ValueError(f"reference parameters the port has no place for: "
                         f"{sorted(set(params) - used)}")
    return out


def lm_arrays_from_state_dict(state: Mapping[str, torch.Tensor],
                              prefixes: Optional[Mapping[str, str]] = None
                              ) -> Dict[str, np.ndarray]:
    """The inverse: the port's state dict (of a model whose
    ``reference_prefixes`` are ``prefixes``) -> the reference's flat dict
    of float32 numpy arrays, stacks on their leading axes."""
    parts: Dict[str, Dict[Tuple[int, ...], np.ndarray]] = {}
    for key, t in state.items():
        ref, idx = lm_reference_name(key, prefixes)
        parts.setdefault(ref, {})[idx] = t.detach().float().cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    for ref, by_idx in parts.items():
        if () in by_idx:
            out[ref] = by_idx[()]
            continue
        lead = tuple(np.max(list(by_idx), axis=0) + 1)
        first = next(iter(by_idx.values()))
        arr = np.empty(lead + first.shape, np.float32)
        for idx, a in by_idx.items():
            arr[idx] = a
        out[ref] = arr
    return out
