"""Batched serving engine: prefill + decode with a static-shape request
batch (fixed [B, S_max] cache slots, greedy or temperature sampling), run
eagerly under ``torch.inference_mode`` on the model's device.

:class:`RelationalFeatureProvider` is the GJ wire-in: per-request
relational features are pulled through a
:class:`~repro_torch.summary.service.JoinService` with a **pre-compiled**
physical plan, so the steady-state request path is a summary-cache hit plus
an O(runs) group-by -- never a join, never a re-plan.  On a ``"cuda"``
service that group-by runs on the card (``mul_segsum``,
``run_boundaries``).

Port of ``src/repro/serve/engine.py``.  The provider is a copy; the
engine is a rewrite: the parameters live in the ``LM`` module, sampling
draws from a ``torch.Generator`` on the device seeded by ``seed``, and
the sampled tokens stay on the device until ``generate`` returns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.model import LM
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span
from repro_torch.serve.server import SingleFlight, lookup_rows


@dataclass
class ServeConfig:
    max_seq: int
    temperature: float = 0.0
    eos_id: int = -1              # -1 => never stop early


class RelationalFeatureProvider:
    """Join-backed feature vectors for serve requests.

        svc = JoinService(catalog)
        prov = RelationalFeatureProvider(
            svc, query, key_var="U1",
            aggs={"n_rows": "count", "total": ("sum", "A2")})
        feats = prov.features(np.asarray([uid0, uid1]))   # [2, 2] float32

    The physical plan is compiled once at construction (`JoinService.
    compile`), so every request keys the summary cache on the same plan
    identity; the first `features` call computes the summary, later calls
    are cache hits.  Keys missing from the join result get zero features.

    The provider survives live table growth: every `features` call
    revalidates the memoized per-key table against the catalog's content
    versions (memoized hashes — a dict compare, no data touched).  After a
    `JoinService.append`, the next call re-pulls the frame, which the
    service satisfies through the incremental refresher under the same
    pre-compiled plan — never a cold rebuild, never a re-plan.  The memo
    rebuild is single-flight: a post-append stampede of concurrent
    `features` calls computes the new per-key table exactly once
    (`serve.feature_recomputes` counts builds, not requests).

    Pass ``server=`` (a :class:`~repro_torch.serve.server.JoinServer`) to
    route lookups through the serving front-end instead of the memo:
    probes then batch across concurrent requests against the server's
    resident table, and cold builds go through its collapse/admission
    machinery.

    The provider is oblivious to summary *shape*: a service configured
    with ``partitions > 1`` hands back shard-merging frames
    (`ShardedSummaryFrame`) whose `group_by` matches the monolithic
    output exactly, so nothing here knows whether the plan was
    partitioned (appends then rebuild instead of splice-refresh — a
    provenance difference, not a value difference).
    """

    def __init__(self, service, query, *, key_var: str,
                 aggs: Dict[str, Any], plan=None, server=None) -> None:
        self.service = service
        self.query = query
        self.key_var = key_var
        self.aggs = dict(aggs)
        self.plan = plan if plan is not None else service.compile(query)
        self.server = server
        # (versions, table) as ONE atomically-assigned pair: concurrent
        # features() calls can never pair an old table with new versions
        # (which would pass revalidation forever and pin stale features)
        self._memo: Optional[Tuple[Dict[str, str],
                                   Dict[str, np.ndarray]]] = None
        # collapses the post-append rebuild stampede: racers on the same
        # versions key share one _feature_table() build
        self._flight = SingleFlight()

    def _feature_table(self) -> Dict[str, np.ndarray]:
        reply = self.service.frame(self.query, plan=self.plan)
        return reply.frame.group_by([self.key_var], **self.aggs)

    def _current_versions(self) -> Dict[str, str]:
        cat = self.service.catalog
        return {qt.table: cat[qt.table].version() for qt in self.query.tables}

    def refresh(self) -> None:
        """Drop the memoized per-key table (e.g. after `invalidate`)."""
        self._memo = None

    @property
    def num_features(self) -> int:
        return len(self.aggs)

    def features(self, keys: np.ndarray) -> np.ndarray:
        """[len(keys), num_features] float32; zeros for unknown keys."""
        with _span("serve:features", cat="serve", keys=len(keys)) as sp:
            REGISTRY.counter("serve.feature_requests").inc()
            if self.server is not None:
                sp.set(via="server")
                return self.server.lookup(self.query, self.key_var, keys,
                                          self.aggs, plan=self.plan)
            versions = self._current_versions()
            memo = self._memo
            fresh = memo is None or memo[0] != versions

            def build(_fl):
                REGISTRY.counter("serve.feature_recomputes").inc()
                return (versions, self._feature_table())

            if fresh:
                # single-flight keyed on the exact version vector: a
                # post-append stampede elects one builder, everyone else
                # shares its table instead of re-deriving it per racer
                memo, _, _ = self._flight.do(
                    tuple(sorted(versions.items())), build)
                self._memo = memo
            sp.set(memo_hit=not fresh)
            return lookup_rows(memo[1], self.key_var, list(self.aggs),
                               np.asarray(keys))


class ServeEngine:
    """``generate`` prefills a prompt batch, then decodes token by token.

    ``device`` must be where ``lm`` lives (``"cuda"`` by default, raising
    without a card); the engine never moves the model.
    """

    def __init__(self, lm: LM, cfg: ServeConfig, *,
                 feature_provider: Optional[RelationalFeatureProvider] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.device = resolve_device(device)
        if lm.device.type != self.device.type:
            raise ValueError(f"the model is on {lm.device}, the engine on "
                             f"{self.device}")
        self.lm = lm
        self.cfg = cfg
        self.feature_provider = feature_provider

    def attach_features(self, batch: Dict[str, Any],
                        keys: np.ndarray) -> Dict[str, Any]:
        """Return ``batch`` + a ``"features"`` tensor on the device, pulled
        through GJ.  No-op when no provider is configured."""
        if self.feature_provider is None:
            return batch
        out = dict(batch)
        out["features"] = torch.from_numpy(
            self.feature_provider.features(keys)).to(self.device)
        return out

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        """[B, 1, V] logits -> [B, 1] tokens."""
        last = logits[:, -1]
        if self.cfg.temperature <= 0.0:
            return last.argmax(dim=-1, keepdim=True)
        probs = torch.softmax(last.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any], max_new: int,
                 *, seed: int = 0) -> np.ndarray:
        """Prefill the prompt batch then decode max_new tokens:
        [B, max_new] int32.

        The first token is sampled from the prefill's logits, so this runs
        ``max_new - 1`` decode steps, one fewer than the reference, which
        decodes once more and discards that step's token: the tokens are
        equal.  ``max_new < 1`` raises ``ValueError`` (the reference's
        empty concatenation raises too), and so does an encoder-only
        model, before any work.  A vlm batch's ``"vision"`` goes to the
        prefill and to every decode step."""
        if self.lm.encoder_only:
            raise ValueError(f"{self.lm.cfg.name} is encoder-only: it "
                             f"does not generate (use make_serve_step("
                             f"lm, mode='prefill') to encode)")
        if max_new < 1:
            raise ValueError(f"max_new must be at least 1, not {max_new}")
        tokens = torch.as_tensor(batch["tokens"]).to(self.device,
                                                     torch.int64)
        vision = batch.get("vision")
        if vision is not None:
            vision = torch.as_tensor(vision).to(self.device)
        gen = torch.Generator(self.device).manual_seed(seed)
        logits, caches = self.lm.prefill(tokens, s_max=self.cfg.max_seq,
                                         vision=vision)
        tok = self._sample(logits, gen)
        out = [tok]
        for _ in range(max_new - 1):
            logits, caches = self.lm.decode_step(tok, caches, vision=vision)
            tok = self._sample(logits, gen)
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def make_serve_step(lm: LM, *, mode: str):
    """The serving entry points as functions of tensors.

    mode == "prefill": (tokens, *, s_max, vision=None) -> (logits, caches);
                       for an encoder-only model (audio) the encode step
                       (inputs, *, vision=None) -> logits [B, S, V]
    mode == "decode":  (tokens, caches, *, vision=None) -> (logits, caches)
    """
    if mode == "prefill":
        if lm.encoder_only:
            def encode_step(inputs, *, vision=None):
                return lm.forward(inputs, vision=vision)
            return encode_step

        def prefill_step(tokens, *, s_max: int, vision=None):
            return lm.prefill(tokens, s_max=s_max, vision=vision)
        return prefill_step

    if mode == "decode":
        def decode_step(tokens, caches, *, vision=None):
            return lm.decode_step(tokens, caches, vision=vision)
        return decode_step

    raise ValueError(mode)
