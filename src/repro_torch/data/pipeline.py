"""The data pipeline where GJ is a first-class feature.

Production LM corpora are relational: documents join quality scores, topic
tags, dedup clusters, license bits.  Assembling a training mixture is an
n-way many-to-many join whose *flat* result is enormously redundant —
exactly the workload GJ targets.  The pipeline therefore:

1. runs GJ once (on the card: ``GraphicalJoin(..., device=).run()``) and
   keeps the small GFJS;
2. each host materializes ONLY its own row-range via
   ``desummarize_range`` — random access into the join result, making the
   expansion embarrassingly parallel and deterministic under any host
   count (elastic re-sharding of data);
3. join rows become token streams through a stateless feature hash, so the
   whole pipeline is checkpointable by storing just (epoch, cursor).

Port of ``src/repro/data/pipeline.py``.  The range expansion and the
hash stay the reference's numpy: the hash's ``>> 33`` is a logical shift
on uint64, which torch's int64 would make arithmetic.  ``next_batch``
hands back int32 tensors on the batcher's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.api import GraphicalJoin
from repro_torch.core.engine import resolve_device
from repro_torch.core.gfjs import GFJS, desummarize_range
from repro_torch.relational.query import JoinQuery
from repro_torch.relational.table import Catalog


@dataclass
class JoinCorpus:
    """A GFJS plus the mapping from join rows to token sequences."""

    gfjs: GFJS
    vocab: int
    tokens_per_row: int = 16

    @staticmethod
    def build(catalog: Catalog, query: JoinQuery, *, vocab: int,
              tokens_per_row: int = 16,
              device: Union[str, torch.device] = "cuda") -> "JoinCorpus":
        gj = GraphicalJoin(catalog, query, device=device)
        gfjs = gj.run()
        return JoinCorpus(gfjs, vocab, tokens_per_row)

    @property
    def num_rows(self) -> int:
        return self.gfjs.join_size

    def host_range(self, host: int, num_hosts: int) -> Tuple[int, int]:
        """Contiguous row range owned by this host (balanced +-1)."""
        n = self.num_rows
        base, rem = divmod(n, num_hosts)
        lo = host * base + min(host, rem)
        hi = lo + base + (1 if host < rem else 0)
        return lo, hi

    def rows_to_tokens(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """[rows, tokens_per_row] int32 via a stateless feature hash."""
        names = sorted(cols)
        n = len(cols[names[0]])
        acc = np.zeros(n, np.uint64)
        for i, v in enumerate(names):
            c = cols[v].astype(np.uint64)
            acc ^= (c + np.uint64(0x9E3779B97F4A7C15)) * np.uint64(2 * i + 1)
        out = np.empty((n, self.tokens_per_row), np.int32)
        state = acc
        for t in range(self.tokens_per_row):
            state = state * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)
            out[:, t] = (state >> np.uint64(33)).astype(np.int64) % self.vocab
        return out

    def materialize_range(self, lo: int, hi: int) -> np.ndarray:
        cols = desummarize_range(self.gfjs, lo, hi, decode=False)
        return self.rows_to_tokens(cols)


@dataclass
class TokenBatcher:
    """Deterministic, checkpointable batch iterator over a host's range."""

    corpus: JoinCorpus
    batch: int
    seq: int
    host: int = 0
    num_hosts: int = 1
    cursor: int = 0          # rows consumed within this host's range (state)
    epoch: int = 0
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def state(self) -> Dict[str, int]:
        return {"cursor": self.cursor, "epoch": self.epoch}

    def load_state(self, state: Dict[str, int]) -> None:
        self.cursor = int(state["cursor"])
        self.epoch = int(state["epoch"])

    def next_batch(self) -> Dict[str, torch.Tensor]:
        lo, hi = self.corpus.host_range(self.host, self.num_hosts)
        tokens_needed = self.batch * (self.seq + 1)
        rows_needed = -(-tokens_needed // self.corpus.tokens_per_row)
        toks: list = []
        got = 0
        while got < tokens_needed:
            start = lo + self.cursor
            take = min(rows_needed, hi - start)
            if take <= 0:
                self.cursor = 0
                self.epoch += 1
                continue
            t = self.corpus.materialize_range(start, start + take)
            self.cursor += take
            toks.append(t.reshape(-1))
            got += t.size
        flat = np.concatenate(toks)[:tokens_needed]
        arr = torch.from_numpy(flat.reshape(self.batch, self.seq + 1))
        arr = arr.to(self.device)
        return {"tokens": arr[:, :-1].contiguous(),
                "labels": arr[:, 1:].contiguous()}
