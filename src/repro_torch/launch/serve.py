"""Serving launcher: batched generation with the KV-cache engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \
        [--smoke] [--device cuda] [--features] \
        [--batch 4 --prompt-len 32 --max-new 16]

Without ``--smoke`` the model is the architecture's full configuration,
built on ``--device`` with random weights from a generator seeded 0.
``--features`` attaches per-user relational features pulled through a
``JoinServer`` in front of a ``JoinService`` on the same device
(lastfm_A1's path counts per user, over a small ``lastfm_like``
catalog).  A vlm model gets seeded image context with each request
(the reference's stub patch embeddings); an encoder-only model (audio)
exits, as in the reference: it encodes through
``make_serve_step(lm, mode="prefill")`` and does not generate.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.models.model import LM
from repro_torch.serve.engine import (RelationalFeatureProvider, ServeConfig,
                                      ServeEngine)

FEATURE_USERS = 200


def make_feature_provider(device) -> RelationalFeatureProvider:
    from repro_torch.relational.synth import lastfm_like
    from repro_torch.serve.server import JoinServer
    from repro_torch.summary.service import JoinService
    cat, qs = lastfm_like(n_users=FEATURE_USERS, n_artists=150,
                          artists_per_user=6, friends_per_user=3)
    svc = JoinService(cat, device=device)
    server = JoinServer(svc, default_deadline=5.0)
    prov = RelationalFeatureProvider(
        svc, qs["lastfm_A1"], key_var="U1", aggs={"n_paths": "count"},
        server=server)
    print("serve plan:", " -> ".join(prov.plan.order),
          f"(chosen={prov.plan.source})")
    return prov


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--features", action="store_true",
                    help="attach GJ relational features to each request")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only; no decode path")
    lm = LM(cfg, device=args.device,
            generator=torch.Generator(args.device).manual_seed(0))

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (args.batch, args.prompt_len))}
    if cfg.family == "vlm":
        batch["vision"] = rng.normal(size=(
            args.batch, cfg.vlm.num_image_tokens,
            cfg.vlm.vision_dim)).astype(np.float32)
    provider = make_feature_provider(args.device) if args.features else None
    engine = ServeEngine(
        lm, ServeConfig(max_seq=args.prompt_len + args.max_new,
                        temperature=args.temperature),
        feature_provider=provider, device=args.device)
    if provider is not None:
        users = rng.integers(0, FEATURE_USERS, args.batch)
        enriched = engine.attach_features(batch, users)
        print("request features:",
              enriched["features"].cpu().numpy().ravel().tolist())
        print("join server:", provider.server.stats())

    out = engine.generate(batch, max_new=args.max_new, seed=1)
    for i, row in enumerate(out):
        print(f"request {i}: {row.tolist()}")


if __name__ == "__main__":
    main()
