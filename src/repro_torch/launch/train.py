"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_8b \
        --smoke --steps 100 --batch 8 --seq 64 [--microbatches 2] \
        [--device cpu]

Runs on the card (``--device cuda``, the default, raising without one);
``--device cpu`` runs the same code on the CPU.  Full-scale configs need
the card's memory: 2 + 4 + 4 bytes a parameter plus the gradients (use
--smoke on the CPU).  Data comes from the GJ-fed pipeline: a synthetic
relational corpus joined by GJ on the same device.  A run resumes from
the latest checkpoint under --checkpoint-dir.  The corpus is tokens
only, so the vlm and audio families, which also need images or frames,
exit (the reference's launcher fails on them too); they train through
``make_train_step`` on batches that carry ``vision`` or ``frames``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import JoinCorpus, TokenBatcher
from repro_torch.models.model import LM
from repro_torch.relational.synth import lastfm_like
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

# the families whose batches need more than the token corpus gives
NO_TOKEN_CORPUS = {"vlm": "image context (vision)",
                   "audio": "audio frames (frames)"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = torch.device(args.device)
    if cfg.family in NO_TOKEN_CORPUS:
        raise SystemExit(
            f"{args.arch}: the {cfg.family} family needs "
            f"{NO_TOKEN_CORPUS[cfg.family]} with each batch, and the "
            f"training corpus holds only tokens")

    cat, queries = lastfm_like(n_users=500, n_artists=400,
                               artists_per_user=8, friends_per_user=4)
    corpus = JoinCorpus.build(cat, queries["lastfm_A1"], vocab=cfg.vocab,
                              device=dev)
    batcher = TokenBatcher(corpus, batch=args.batch, seq=args.seq,
                           device=dev)

    trainer = Trainer(
        lambda gen: LM(cfg, device=dev, generator=gen),
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps),
        batcher,
        TrainerConfig(steps=args.steps, checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.checkpoint_dir,
                      log_every=max(args.steps // 10, 1),
                      microbatches=args.microbatches),
        device=dev,
    )
    trainer.run()
    for m in trainer.metrics_log:
        print(f"step {m['step']:>5d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}")


if __name__ == "__main__":
    main()
