"""Rows of a join, judged as a multiset, and the plain rows themselves.

:func:`fingerprint` reads a result given as one index column per variable
on any device, with the raw value of each index, and returns
``sum over rows of prod_v w_v(value) mod P``, where ``w_v`` is a seeded
hash of the raw value.  :func:`expected` works the same sum out from the
tables by sum-product over the join tree.  Two multisets of rows that
differ give equal sums with probability at most (number of variables)/P
for each independent salt (the sum is a polynomial whose monomials are the
distinct rows); :data:`SALTS` salts give two sums.

:func:`expand` is the result itself, made in plain PyTorch by expanding one
relation at a time: the control puts it in the program's place.
"""

from __future__ import annotations

import zlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from gjbench.reference.join import P, Tree, propagate

SALTS = 2
CHUNK = 1 << 26                       # rows per device step of the sum
_M64 = (1 << 64) - 1


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def weights(var: str, values: np.ndarray, seed: int, salt: int
            ) -> np.ndarray:
    """w_var(value) in [1, P): int64, from the seed, the salt and the name."""
    key = (zlib.crc32(var.encode()) * 0x100000001B3 + seed * 0x9E37 + salt
           * 0x85EBCA6B) & _M64
    with np.errstate(over="ignore"):
        h = _splitmix(values.astype(np.int64).view(np.uint64) ^ np.uint64(key))
    return (h % np.uint64(P - 1)).astype(np.int64) + 1


def expected(tree: Tree, seed: int) -> Tuple[int, ...]:
    """The fingerprints of the join's rows, from the tables."""
    root = tree.edges[0].a
    return tuple(int(propagate(tree, root, {
        v: weights(v, d, seed, s) for v, d in tree.domains.items()},
        ring="mod").sum() % P) for s in range(SALTS))


def fingerprint(columns: Dict[str, torch.Tensor],
                values: Dict[str, np.ndarray], seed: int
                ) -> Tuple[Tuple[int, ...], int]:
    """(fingerprints, rows) of a result: ``columns[v]`` indexes
    ``values[v]``.  Raises ``ValueError`` on an index outside its values
    or columns of unequal length."""
    names = sorted(columns)
    n = {int(columns[v].numel()) for v in names}
    if len(n) != 1:
        raise ValueError(f"columns of unequal length: {sorted(n)}")
    n = n.pop()
    for v in names:
        c = columns[v]
        if n and (int(c.min()) < 0 or int(c.max()) >= len(values[v])):
            raise ValueError(f"column {v} indexes outside its values")
    dev = columns[names[0]].device
    out = []
    for s in range(SALTS):
        tabs = {v: torch.from_numpy(weights(v, values[v], seed, s)).to(dev)
                for v in names}
        total = 0
        for lo in range(0, n, CHUNK):
            acc = None
            for v in names:
                w = tabs[v][columns[v][lo:lo + CHUNK].long()]
                acc = w if acc is None else (acc * w) % P
            total = (total + int(acc.sum()) % P) % P
        out.append(total)
    return tuple(out), n


def expand(tree: Tree, order: Sequence[str], device
           ) -> Dict[str, torch.Tensor]:
    """Every row of the join as int32 indices into ``tree.domains``, one
    relation at a time (``order`` lists the variables so that each after
    the first shares a relation with one before it)."""
    dev = torch.device(device)
    first = next(e for e in tree.edges if {e.a, e.b} == set(order[:2]))
    cols = {first.a: torch.from_numpy(first.xa).to(dev),
            first.b: torch.from_numpy(first.xb).to(dev)}
    for var in order[2:]:
        e = next(e for e in tree.edges
                 if var in (e.a, e.b) and ({e.a, e.b} - {var}) <= set(cols))
        bound, key, val = (e.a, e.xa, e.xb) if e.b == var else \
            (e.b, e.xb, e.xa)
        srt = np.argsort(key, kind="stable")
        key_t = torch.from_numpy(key[srt]).to(dev)
        val_t = torch.from_numpy(val[srt].astype(np.int32)).to(dev)
        cols = _join_step(cols, bound, var, key_t, val_t)
    return {v: c.to(torch.int32) for v, c in cols.items()}


def _join_step(cols, bound, var, key, val):
    at = cols[bound].long()
    lo = torch.searchsorted(key, at)
    cnt = torch.searchsorted(key, at, right=True) - lo
    ends = torch.cumsum(cnt, 0)
    total = int(ends[-1]) if len(ends) else 0
    out = {v: torch.empty(total, dtype=torch.int32, device=key.device)
           for v in [*cols, var]}
    n, start, i = len(at), 0, 0
    while i < n:
        # the next block of input rows whose output fits one CHUNK
        j = int(torch.searchsorted(ends, ends.new_tensor(start + CHUNK),
                                   right=True))
        j = max(j, i + 1)
        stop = int(ends[j - 1])
        rep = torch.repeat_interleave(torch.arange(i, j, device=key.device),
                                      cnt[i:j], output_size=stop - start)
        pos = torch.arange(start, stop, device=key.device) \
            - (ends[rep] - cnt[rep]) + lo[rep]
        for v, c in cols.items():
            out[v][start:stop] = c[rep].to(torch.int32)
        out[var][start:stop] = val[pos]
        i, start = j, stop
    return out
