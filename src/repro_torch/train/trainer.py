"""The fault-tolerant training driver (``repro/train/trainer.py``).

Responsibilities beyond calling the train step in a loop:

* periodic checkpoints (params + optimizer + data-iterator state),
  resume-from-latest on start — preemption-safe by construction;
* deterministic data order across restarts (the batcher cursor is part of
  the checkpoint, so a resumed run consumes exactly the batches the dead
  run would have);
* failure injection hooks for the FT test-suite (`crash_after_step`);
* straggler mitigation at the host level: data batches are produced by a
  lookahead prefetch thread so a slow storage read never stalls the step.

``Trainer(lm, ...)`` takes a model, or a factory ``lm(generator) -> LM``
that builds one on the trainer's device.  ``run(seed)`` draws the weights
from ``torch.Generator(device).manual_seed(seed)`` (re-drawing a given
model's), as the reference's ``lm.init(jax.random.key(seed))``, then
restores the latest checkpoint into them in place.  ``step_seconds``
holds each step's host time, read when its metrics are (every step where
``log_every == 1``), without the checkpoint saves.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.models.model import LM
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)


class _Prefetcher:
    """Lookahead batch producer (host-level straggler mitigation).

    Each queue item is (batch, iterator-state-after-this-batch): the trainer
    checkpoints the state of the last *consumed* batch, never the producer's
    lookahead position — that is what makes crash/resume bit-exact even with
    prefetching.  A failure in the producer is handed to the consumer.
    """

    def __init__(self, make_batch: Callable[[], Dict],
                 get_state: Callable[[], Dict], depth: int = 2) -> None:
        self.make_batch = make_batch
        self.get_state = get_state
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        pending = None
        while not self.stop.is_set():
            if pending is None:
                try:
                    batch = self.make_batch()
                    pending = (batch, dict(self.get_state()))
                except Exception as exc:     # handed to next()
                    pending = exc
            try:
                self.q.put(pending, timeout=0.5)
                if isinstance(pending, Exception):
                    return
                pending = None
            except queue.Full:
                continue

    def next(self) -> Tuple[Dict, Dict]:
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self.stop.set()
        self.thread.join()


@dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    log_every: int = 10
    microbatches: int = 1
    crash_after_step: Optional[int] = None   # failure injection (tests)


class Trainer:
    def __init__(self, lm: Union[LM, Callable[[torch.Generator], LM]],
                 opt_cfg: AdamWConfig, batcher: TokenBatcher,
                 cfg: TrainerConfig, *,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.device = resolve_device(device)
        if isinstance(lm, LM) and lm.device.type != self.device.type:
            raise ValueError(f"the model is on {lm.device}, the trainer on "
                             f"{self.device}")
        self.lm: Optional[LM] = lm if isinstance(lm, LM) else None
        self._factory = None if isinstance(lm, LM) else lm
        self.opt_cfg = opt_cfg
        self.batcher = batcher
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.checkpoint_dir)
        self.metrics_log: List[Dict[str, float]] = []
        self.step_seconds: List[float] = []

    def _init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(self.device).manual_seed(seed)
        if self._factory is not None:
            self.lm = None            # free the last run's model first
            self.lm = self._factory(gen)
        else:
            self.lm.init_weights(gen)
        return init_train_state(self.lm)

    def run(self, seed: int = 0) -> TrainState:
        cfg = self.cfg
        start_step = 0
        state = self._init_state(seed)
        self.ckpt.prefixes = self.lm.reference_prefixes
        step_fn = make_train_step(self.lm, self.opt_cfg,
                                  microbatches=cfg.microbatches)
        if self.ckpt.latest_step() is not None:
            state, start_step, extra = self.ckpt.restore(state, into=True)
            self.batcher.load_state(extra["batcher"])

        prefetch = _Prefetcher(self.batcher.next_batch, self.batcher.state)
        try:
            t0 = time.perf_counter()
            for step in range(start_step, cfg.steps):
                batch, consumed_state = prefetch.next()
                state, metrics = step_fn(state, batch)
                if (step + 1) % cfg.log_every == 0 or step == cfg.steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step + 1
                    self.metrics_log.append(m)
                    t1 = time.perf_counter()
                    self.step_seconds.append(t1 - t0)
                    t0 = t1
                if (step + 1) % cfg.checkpoint_every == 0:
                    self.ckpt.save(step + 1, state,
                                   extra={"batcher": consumed_state})
                    t0 = time.perf_counter()
                if cfg.crash_after_step is not None and \
                        (step + 1) == cfg.crash_after_step:
                    raise RuntimeError("injected failure (test)")
        finally:
            prefetch.close()
            self.ckpt.wait()
        return state
