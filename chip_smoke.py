#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

    python3 chip_smoke.py [--out FILE]      # from the repository root

Phases, each fatal on failure (exit code 1, no result line):

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build every kernel of the path from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together) and print ``-Xptxas -v``;
3. each kernel (``expand_many``, ``mul_segsum``, ``run_boundaries``,
   ``expand_gather``, ``dense_message``) against its plain PyTorch version
   on small edge cases;
4. ``lastfm_A1`` at Last.fm-2k scale (HetRec 2011: 1,892 users, 17,632
   artists) through ``repro_torch.GraphicalJoin(...).run()`` and
   ``.desummarize()`` on the card, held exactly against the same package's
   numpy generation and numpy desummarization.  ``desummarize`` runs after
   ``run()`` (on the device memo that generation leaves: no upload, no
   host prefix sums, both checked), again, and on a memo-free copy of the
   GFJS (which uploads its levels), the three ``torch.equal``; each call's
   ``engine:upload`` / ``engine:download`` bytes, ``summarize``'s split
   between its ``gfjs:level:*`` and ``engine:download`` spans (none since
   a level's host arrays download on their first read), the memo's
   ``aux_nbytes``, peak device bytes, and the card's busy share of
   ``run()`` and ``desummarize`` (profiler trace);
5. ``lastfm_A2`` at the same scale, generated and desummarized on the card
   (codes kept on the device), checked by its join size, its column
   lengths and windows against the numpy ``desummarize_range``; the same
   three desummarize calls (the first call's columns freed before the
   second; the memo-free copy's ``torch.equal`` to the second's), and the
   routes that download a level's int32 codes as int64 (widened on the
   card or on the host, pageable or through pinned staging) timed on its
   deepest level;
6. the summary side on the card: ``GraphicalJoin.aggregate`` over the
   GFJS of phases 4-5 (COUNT, GROUP BY, SUM, MEAN, a filtered GROUP BY, a
   store -> load -> GROUP BY round trip), each held against the same frame
   on ``device="cpu"`` and split into host, upload and device time; and
   ``engine.build_factor`` (GROUP BY COUNT on the card) over the 38.3M
   desummarized ``(U1, A2)`` rows of lastfm_A1, held against numpy
   ``Factor.from_columns`` and against the summary's GROUP BY;
7. the kernel API and the dense message path at the same scale, on the
   card: ``engine.maybe_dense_message`` over the ``user_friends`` potential
   (1,892 x 1,892) recomputes lastfm_A1's and lastfm_A2's join sizes
   (one message, then two chained), each message held bit for bit against
   the numpy route (``multiply`` then ``marginalize_out``); ``ops.rle_expand``
   and ``ops.expand_indices`` over lastfm_A1's 1,004,489-run level, held
   against phase 4's column and the plain versions; and ``desummarize``
   twice, the second call reusing every level's memoized device bounds;
8. each kernel at the shapes its path gave it (recorded by its ``kernel:``
   spans in phases 4-7; for the new kernels also the reference benchmark's
   shapes): exact against its plain version, and timed with CUDA events
   beside its bound, the plain version and one PyTorch call computing the
   same function where there is one (``repeat_interleave``, ``index_add_``,
   ``torch.matmul``); the dense message also per call in a CUDA graph (the card's time without the
   host's launch cost), cold (rotating over copies of phi that overflow
   L2) beside warm, and swept over K, thin kernel against tiled; each
   redesigned kernel's time under its previous design beside its new one;
9. the serving path on the card, at the same scale, under one tracer:
   (a) ``JoinServer(JoinService(device="cuda", incremental=True))``:
   lastfm_A1 raced cold by 8 threads (one traced build on numpy, 7
   ``"collapsed"`` replies), then ``"memory"``; COUNT, SUM, MEAN, GROUP BY
   and a filtered GROUP BY through the service, each held against the
   same frame on ``device="cpu"`` and split into host, transfer and card
   time; batched ``lookup`` of all user ids from 8 threads against
   ``lookup_rows``; a 1 % append to ``user_friends`` (ids past the
   domain), after which the frame is ``"refreshed"`` and equal, level for
   level and in its aggregates and columns, to a cold rebuild on the card.
   (b) ``JoinService(device="cuda", incremental=False)`` with a 1 GiB
   budget: lastfm_A1 under two plans (the second evicts the first to disk;
   once no reply holds it, the card's allocated bytes fall by its memo;
   it comes back from ``"disk"`` with the same answers), lastfm_A2 built
   on the card, warm, COUNT and GROUP BY against ``device="cpu"``, rebuilt
   after ``cache.clear()`` with message-cache hits and an identical GFJS,
   and ``invalidate`` freeing its memo.  The trace passes
   ``obs.check.validate(expect_server=True, expect_msgcache=True)``;
10. partitioned builds on the card, at the same scale, under one tracer:
   (a) lastfm_A1 with ``partitions=4`` (thread executor): each shard equal
   level for level to the same shards generated on numpy, the shard join
   sizes summing to phase 4's, the desummarized rows equal to phase 4's
   as a multiset (packed into one int64 key and sorted on the card),
   COUNT, SUM, MEAN, GROUP BY A1 and the filtered GROUP BY through
   ``ShardedSummaryFrame`` equal to phase 6's monolithic answers, and
   ``partition_histogram`` on the card equal to ``np.bincount`` of the
   numpy hash; (b) lastfm_A2 with ``partitions=4``: the join size, COUNT
   and GROUP BY A2 against phases 5-6, and each shard's column windows
   against numpy ``desummarize_range``; (c) lastfm_A1 with 2 shards
   generated on numpy in spawned workers (``shard_executor="process"``),
   equal to the thread executor's; (d) ``JoinService(partitions=4)``:
   computed, memory, answers equal (a)'s, an append rebuilds, and
   ``invalidate`` frees the shards' memos.  Each prints its shard report,
   ``aux_nbytes`` and peak device bytes; the trace passes
   ``obs.check.validate(expect_shards=True)``;
11. the LM serving path on the card: (a) ``qwen3_8b`` at full width
   (two layers, float32): prefill + stepwise decode logits equal the
   teacher-forced ``forward``'s, in the grouped and the repeated KV
   layouts, which agree; (b) the ``qwen3_8b`` and ``gemma3_4b`` smoke
   models on the card against the same weights on the CPU (logits, and
   8 greedy tokens equal); (c) the full Qwen3-8B (36 layers, bf16, random
   weights drawn on the card from seed 0) serving 4 x 3,072-token prompts
   (the online attention path) and 8 x 256 (the dense path), 32 new
   tokens each, the prompts from ``JoinCorpus.build`` over lastfm_A1 on
   the card through ``TokenBatcher(device="cuda")``, each request's
   features from a ``RelationalFeatureProvider`` over a card
   ``JoinService`` (equal to ``group_by`` on ``device="cpu"``): two greedy
   runs equal, sampled runs with seeds 1 and 2 different; prefill seconds
   and tokens/s, decode ms per step, each beside its bound, the card's
   busy share of a decode loop and peak device bytes;
12. the moe family's serving path on the card, for granite-moe-1b-a400m
   (24 layers, 32 experts top-8) and deepseek-v2-236b (MLA, 160 routed
   experts top-6 and 2 shared; 4 of its 60 layers, one dense and three
   MoE, for one card): (a) each at full width, two layers, float32,
   drop-free (capacity factor 64): prefill + stepwise decode logits equal
   the teacher-forced ``forward``'s (deepseek: the absorbed-latent decode
   against the expanded forward); (b) both smoke models at the configs'
   capacity (drops included, counted) on the card against the CPU, as
   phase 11 (b), and two card runs bit-equal; (c) both models in bf16
   serving phase 11's join-fed batches with its checks and measurements;
13. training on the card, fed by GJ: ``JoinCorpus.build`` over lastfm_A1
   on the card (``expand_many`` launched); (a) the qwen3_8b and granite
   smoke models in float32 (granite drop-free) on the card against the
   same weights on the CPU: the loss, every gradient and the parameters
   after two AdamW steps to a relative 1e-5 (L2, per tensor), and two
   card runs of three steps bit-equal under
   ``torch.use_deterministic_algorithms(True)`` (granite at its own
   capacity; ``CUBLAS_WORKSPACE_CONFIG`` is set before the first CUDA
   call); (b) the qwen3_8b smoke model through ``Trainer`` for 8 steps,
   checkpoints every 4, a crash after step 6, resumed: bit-equal to an
   uninterrupted run; (c) granite-moe-1b-a400m at full size (24 layers,
   bf16, random weights drawn on the card) training 20 steps of 8 x 1,024
   join-fed tokens through ``Trainer`` and ``TokenBatcher(device=
   "cuda")``: the loss falls, every loss and grad norm finite; ms per
   step, tokens/s, the card's busy share of 5 more steps with kernel
   seconds by name (2 for (d)), peak device bytes and ``train_bounds``; then its
   whole train state (13.4 GB) saved once and restored, timed, every
   crc32 checked; (d) Qwen3-8B at full width with its depth cut to 12 of
   36 layers (printed as ``reduced``), 5 steps of 2 x 4,096 tokens (the
   online attention path and its backward), measured as (c);
14. the recurrent families on the card, zamba2-2.7b (Mamba2 layers and
   one shared attention block applied at the head of every unit of 6)
   and xlstm-350m (mLSTM + sLSTM units): (a) each at full width in
   float32, its depth cut to one unit and a tail (7 of 54 layers, 3 of
   24): prefill + stepwise decode logits equal the teacher-forced
   ``forward``'s, as phase 11 (a); (b) both smoke models on the card
   against the CPU, as phase 11 (b), and two card runs bit-equal; (c)
   both at full size in bf16 (zamba2's 54 layers, ~2.4 B parameters;
   xLSTM's 24) serving phase 11's join-fed batches with its checks and
   measurements (``lm_bounds`` counts the recurrent states and the
   chunked products; xLSTM, whose sLSTM prefill loops over time, with one
   greedy run beside the timed one and no sampled runs, printed); (d)
   both smoke models' loss, gradients and parameters after two AdamW
   steps, card against CPU, as phase 13 (a);
15. the vlm and audio families on the card, llama-3.2-vision-11b (units
   of 4 self-attention layers and one image cross-attention layer) and
   hubert-xlarge (48 non-causal blocks over 512-wide frame embeddings):
   (a) Llama-3.2-Vision at full width in float32, 6 of its 40 layers (one
   unit and a tail layer), prefill + stepwise decode logits with seeded
   image context ``[2, 1601, 1280]`` equal the teacher-forced
   ``forward``'s, as phase 11 (a); HuBERT at full width in float32, 2 of
   its 48 layers, the card's logits against the CPU's at 2 x 256 frames
   (the dense path) and 1 x 3,072 (the online one), and another last
   frame moves position 0's logits (no causal mask); (b) both smoke
   models on the card against the CPU (the vlm's greedy tokens equal) and
   two card runs bit-equal; (c) both at full size in bf16:
   Llama-3.2-Vision serving phase 11's join-fed batches with seeded image
   context per request (``lm_bounds`` counts the cross layers' image K/V,
   recomputed at every decode step, and their products), HuBERT encoding
   seeded frames of the same shapes through ``make_serve_step(mode=
   "prefill")`` with each request's features from the same provider (two
   encodes bit-equal; encode seconds beside the bound of a non-causal
   encoder); (d) both smoke models' loss, gradients and parameters after
   two AdamW steps, card against CPU, as phase 13 (a);
16. data parallelism across ranks, each rank a process started with the
   ``"spawn"`` method and each part joined with a timeout (a rank that
   fails or hangs fails the phase): the batches come from
   ``JoinCorpus.build`` over lastfm_A1 on the card (``expand_many``
   launched) and the codes from lastfm_A1's A1 column desummarized on the
   card.  (a) One NCCL rank per card (world = ``torch.cuda.device_count()``,
   printed; the ``("data",)`` mesh of ``launch/mesh.py``): granite-moe at
   full size, phase 13's 8 x 1,024 join-fed tokens and AdamW lr 1e-3, each
   rank its rows.  Three uncompressed ``make_dp_shard_map_step`` steps in
   deterministic mode against three ``make_train_step`` steps on the whole
   batch from the same seed (one microbatch a rank): bit-equal parameters
   and losses at world 1 (an all-reduce over one rank and a division by
   1.0 change no bit), within ``DP_WORLD_TOL`` (L2, per tensor; the
   grad norms within ``DP_GNORM_RTOL``) at a larger world; three
   compressed steps from the same start, each loss within 0.05 of the
   uncompressed step's, every residual finite.  Measured with no gate: ms
   a step, the busy share and kernel seconds by name of one more compressed
   step, and the compressed all-reduce of one step's gradients alone, by
   kernel.  The cross-rank ``partition_histogram`` of the A1 column (one
   contiguous slice a rank; k = 2, 4, 7, salt 3) equal to
   ``np.bincount(hash_partition(...))`` and the one-device histogram, and
   its seconds.  (b) Two ranks on the one card over gloo with CUDA tensors
   (NCCL refuses two ranks on one card): one uncompressed DP step of the
   qwen3_8b smoke model (2 layers, float32, 8 x 16; the warmup's first
   step at the full lr, so that the parameters move ~3e-4) within 2e-5 of
   the one-rank step on the whole batch, its loss within 2e-5 and its grad
   norm within ``DP_GNORM_RTOL``; ``compressed_psum`` of each rank's
   card tensors bit-equal to the same arrays' on the CPU; (a)'s histogram
   over 2 ranks equal to numpy;
17. the sharded train step: ``train_step.make_train_step`` on parameters
   that ``launch/specs.py``'s ``place_params`` replaced by DTensors placed
   by ``arch_rules`` and on a batch placed by ``batch_shardings``, the
   ranks spawned and joined as in phase 16: one NCCL rank per card on
   ``make_local_mesh(model=world)``, Qwen3-8B at phase 13 (d)'s width and
   depth, three steps of 2 x 4,096 join-fed tokens (from
   ``JoinCorpus.build`` over lastfm_A1 on the card) in deterministic mode,
   plain and then placed from the same seed: the parameters (and losses)
   bit-equal at world 1 (or within phase 13's 1e-5, L2, and the tensors
   named); at a larger world each step's loss within ``SP_LOSS_GAP`` of
   the one-card step's (the bf16 products split over the model axis).
   Measured with no
   gate: ms a step, plain and placed, the placement's time, peak bytes,
   and the busy share and kernel seconds by name of one more placed step.
   (Several gloo ranks sharing the card cannot stand in for a larger
   world: DTensor's all-gather, the functional collective, crashes on
   gloo with CUDA tensors in torch 2.11; tests/test_torch_sharding.py
   runs a (2, 2) mesh on the CPU);
18. every family's cells on DTensor placements, at world 1 on the (1, 1)
   mesh of a one-rank NCCL group in the smoke's own process, each placed
   with ``launch/specs.py``'s ``place_cell`` (as the dry run places its
   cells) against the plain path from the same seed, in deterministic
   mode: (a) granite-moe-1b-a400m at full size, three steps of phase 13's
   8 x 1,024 join-fed tokens, parameters and losses bit-equal, ms a step
   beside ``train_bounds``, the busy share and peak bytes; (b) zamba2 and
   xLSTM at phase 14's width and depths (7, 3), two steps each of
   ``PC_REC_BATCH``, bit-equal; (c) Qwen3-8B and granite-moe at full size
   serving a 4 x 3,072 join-fed prefill and 16 greedy tokens on placed
   parameters and placed caches: tokens equal to the plain run's, logits
   bit-equal (or within phase 11's 1e-3 x max|logits|), prefill s and
   decode ms a step beside the plain run's and ``lm_bounds``; (d) phase
   17's Qwen3-8B cell and (a)'s granite cell through the dry run's
   machinery on meta (``launch/dryrun.py``: a fake one-rank world, the op
   counter), their FLOPs held to ``train_bounds``' operations moved to
   what the port runs: the whole score square, remat's recompute without
   the dense down projection, and the MoE padding (``PC_FLOPS_TOL``),
   their per-device argument bytes equal to the card's placed state and
   batch, and their roofline terms at the H100's peaks beside the card's
   ms a step;
19. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Kernel launch counts are zeroed just before phase 4 and read just after
phase 5 (``expand_many``: the main path), zeroed again just before phase 6
and read just after it (``mul_segsum``, ``run_boundaries``: the summary
path), again around phase 7's path (``expand_gather``,
``dense_message``), around phase 9 (``expand_many``, ``mul_segsum``,
``run_boundaries``: the serving path), around phase 10 (the same
three: the partitioned path), around phase 11 (the same three: the
LM serving path's corpus build and features), around phase 12 (the
same three: the moe serving path's), around phase 13
(``expand_many``: the training path's corpus build), around phase 14
(the three of phase 11: the recurrent families' serving path), around
phase 15 (the same three: the vlm and audio families'), around phase
16 (``expand_many``: the data-parallel path's corpus build and column;
the ranks launch none of the port's kernels) and around phase 17
(``expand_many``: the sharded path's corpus build) and around phase 18
(the same).  ``--out``
writes the per-shape measurements as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM data sheet, CUDA cores
# CUDA C++ Programming Guide, arithmetic instruction throughput: 32-bit
# integer multiply-add, 64 per clock per SM at compute capability 9.0
IMAD_PER_CLOCK_PER_SM = 64
# dense_message.cu: each thread's 4 x 4 micro-tile over a 16-deep V step
DENSE_MACS_PER_STEP = 4 * 4 * 16
LASTFM_2K = dict(n_users=1892, n_artists=17632, artists_per_user=49,
                 friends_per_user=7, seed=0)
L2_BYTES = 50 * 2**20              # H100 SXM; the device's own where known
# the times of the two redesigned kernels under their previous designs (a
# thread per output; 64 x 64 tiles at every K), from this script on an
# H100 80GB HBM3 at 700 W (PERF.md §6); expand_many's is the kernels
# line's sum over lastfm_A1's shapes
PREVIOUS_MS = {("dense_message", 1892, 1892, 1, "int32"): 0.2843,
               ("dense_message", 2048, 2048, 128, "float32"): 0.1391,
               ("dense_message", 2048, 2048, 128, "int32"): 0.3426,
               ("expand_gather", "lastfm_A1"): 0.5639,
               ("expand_gather", "benchmark"): 0.1221,
               ("expand_many", "lastfm_A1"): 2.9388}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| of two [K, n] int32 tensors, row by row (an
    int64 copy of a whole 20 GB output would not fit beside it)."""
    if torch.equal(got, want):
        return 0
    return max(int((g.long() - w.long()).abs().max())
               for g, w in zip(got, want) if g.numel())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


# -- phase 1-2: the card and the build ---------------------------------------

def device_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    build.build(names)
    print(f"build: {names} in {time.perf_counter() - t0:.3f}s "
          f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name in names:
        for line in build.PTXAS.get(name, "(cached build)").splitlines():
            if "registers" in line or "Compiling" in line \
                    or "cached" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")


# -- phase 3: small edge cases ----------------------------------------------

def edge_cases():
    """(name, payloads [K, runs] int32, freqs [runs]) from fixed seeds."""
    rng = np.random.default_rng(0)
    out = []
    for n_runs, k in ((1, 1), (7, 2), (513, 5), (1200, 3)):
        out.append((f"sweep-{n_runs}x{k}",
                    rng.integers(0, 1 << 20, (k, n_runs)).astype(np.int32),
                    rng.integers(1, 9, n_runs)))
    freqs = rng.integers(0, 4, 600)
    freqs[::7] = 0
    out.append(("empty-runs",
                rng.integers(0, 1 << 20, (3, 600)).astype(np.int32), freqs))
    out.append(("zero-length-edges", np.arange(14, dtype=np.int32)
                .reshape(2, 7), np.asarray([0, 0, 3, 0, 2, 0, 0])))
    out.append(("single-run", np.asarray([[9], [4]], np.int32),
                np.asarray([6])))
    out.append(("ragged-total",
                rng.integers(0, 1 << 30, (1, 777)).astype(np.int32),
                rng.integers(1, 7, 777)))
    out.append(("all-runs-empty", np.ones((4, 5), np.int32),
                np.zeros(5, np.int64)))
    out.append(("no-runs", np.zeros((3, 0), np.int32), np.zeros(0, np.int64)))
    return out


def check_edge_cases(dev) -> int:
    """expand_many against its plain version and np.repeat on the cases
    above and on the card tests' (tests/torch_cases.py: the per-tile run
    window's edges, rows off the 16-byte grid, Zipf run lengths)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import expand_cases
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.ref import expand_many_ref
    err = 0
    cases = edge_cases() + [(n, p, f) for n, (p, f) in
                            sorted(expand_cases().items())]
    for name, payloads, freqs in cases:
        bounds = np.cumsum(freqs).astype(np.int32)
        total = int(bounds[-1]) if len(bounds) else 0
        p = torch.from_numpy(payloads).to(dev)
        b = torch.from_numpy(bounds).to(dev)
        got = expand_many(p, b, total)
        want = expand_many_ref(p, b, total)
        sync(dev)
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
        e = max_abs_err(got, want)
        check(e == 0, f"{name}: kernel differs from plain version by {e}")
        oracle = np.stack([np.repeat(r, freqs) for r in payloads])
        check(np.array_equal(got.cpu().numpy(), oracle), f"{name}: np.repeat")
        err = max(err, e)
    print(f"edge cases: expand_many {len(cases)} exact against the plain "
          f"version")
    return err


def check_summary_kernel_cases(dev):
    """mul_segsum and run_boundaries against their plain versions on the
    card tests' edge cases (tests/torch_cases.py): N = 0 and 1, one
    segment over every tile, every entry its own segment, changes on tile
    and thread edges, gaps, past-2^40 and negative int64, float64,
    int32 extremes.  Exact, except non-integral float64 sums (rtol 1e-12:
    the kernel adds in tile order, the plain version in another).
    Returns each kernel's largest exact-case error."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import boundaries_cases, segsum_cases
    from repro_torch.kernels.mul_segsum import mul_segsum
    from repro_torch.kernels.ref import mul_segsum_ref, run_boundaries_ref
    from repro_torch.kernels.run_boundaries import run_boundaries
    seg_err = 0
    cases = segsum_cases()
    for name, (seg, x, y, s) in cases.items():
        args = [torch.from_numpy(a).to(dev) for a in (seg, x, y)]
        got, want = mul_segsum(*args, s), mul_segsum_ref(*args, s)
        sync(dev)
        check(got.dtype == want.dtype and got.shape == (s,),
              f"mul_segsum {name}: {got.dtype} {tuple(got.shape)}")
        if name == "f64":
            check(torch.allclose(got, want, rtol=1e-12, atol=1e-9),
                  f"mul_segsum {name}: beyond rtol 1e-12")
            check(torch.equal(got, mul_segsum(*args, s)),
                  f"mul_segsum {name}: differs between two runs")
            continue
        e = float((got - want).abs().max()) if s else 0.0
        check(e == 0, f"mul_segsum {name}: differs from plain by {e}")
        seg_err = max(seg_err, e)
    b_err = 0
    bcases = boundaries_cases()
    for name, keys in bcases.items():
        k = torch.from_numpy(keys).to(dev)
        got, want = run_boundaries(k), run_boundaries_ref(k)
        sync(dev)
        e = int((got - want).abs().max()) if keys.size else 0
        check(e == 0, f"run_boundaries {name}: differs from plain by {e}")
        b_err = max(b_err, e)
    print(f"edge cases: mul_segsum {len(cases)}, run_boundaries "
          f"{len(bcases)}, against the plain versions")
    return seg_err, b_err


def dense_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| (0 when equal; float64 for the measure only)."""
    if torch.equal(got, want):
        return 0
    return float((got.double() - want.double()).abs().max())


def check_message_kernel_cases(dev):
    """expand_gather and dense_message against their plain versions on the
    card tests' edge cases (tests/torch_cases.py): a single run,
    zero-length runs (100,000 in one tile), total 0, float32 payloads whose
    NaN and -0.0 bit patterns must survive, totals at a block and a tile
    edge, a run over many tiles; P, V, K in {1, 63, 64, 65, 1025}, K about
    THIN_K, V % 4 in {0, 1, 3}, P = 1 with V = 2^20 (the V split),
    misaligned offset views, empty dimensions, products and sums past 2^24
    and 2^40, int64 wrapping, negative counts, and float32 sums of
    integers below 2^24 (exact in the kernel's f32 and the plain version's
    f64).  All exact (float payloads bit for bit).  Returns each kernel's
    largest error."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import dense_cases, dense_tensors, gather_cases
    from repro_torch.kernels.dense_message import dense_message
    from repro_torch.kernels.expand_gather import expand_gather
    from repro_torch.kernels.ref import dense_message_ref, expand_gather_ref
    g_err = 0
    gcases = gather_cases()
    for name, (payload, freqs) in gcases.items():
        bounds = np.cumsum(freqs).astype(np.int32)
        total = int(bounds[-1]) if len(bounds) else 0
        p = torch.from_numpy(payload).to(dev)
        b = torch.from_numpy(bounds).to(dev)
        got = expand_gather(p, b, total).view(torch.int32)
        want = expand_gather_ref(p, b, total).view(torch.int32)
        sync(dev)
        check(got.shape == (total,), f"expand_gather {name}: shape")
        e = max_abs_err(got[None], want[None])
        check(e == 0, f"expand_gather {name}: differs from plain by {e}")
        check(np.array_equal(got.cpu().numpy(),
                             np.repeat(payload, freqs).view(np.int32)),
              f"expand_gather {name}: np.repeat")
        g_err = max(g_err, e)
    d_err = 0
    dcases = dense_cases()
    for name, (phi, m) in dcases.items():
        a, b = dense_tensors(name, phi, m, dev)
        got, want = dense_message(a, b), dense_message_ref(a, b)
        sync(dev)
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"dense_message {name}: {got.dtype} {tuple(got.shape)}")
        e = dense_err(got, want)
        check(e == 0, f"dense_message {name}: differs from plain by {e}")
        d_err = max(d_err, e)
    print(f"edge cases: expand_gather {len(gcases)}, dense_message "
          f"{len(dcases)}, against the plain versions")
    return g_err, d_err


# -- phases 4-5: the main path -----------------------------------------------

def kernel_shapes(tracer, query: str):
    """(phase, k, runs, total) of every expansion launched under a span."""
    spans = {s.span_id: s for s in tracer.spans}
    out = []
    for s in tracer.spans:
        if s.name != "kernel:rle_expand_many":
            continue
        p = spans.get(s.parent_id)
        while p is not None and not p.name.startswith(("gfjs:",
                                                       "desummarize:")):
            p = spans.get(p.parent_id)
        phase = "generate" if p is not None and p.name.startswith("gfjs:") \
            else "desummarize"
        out.append(dict(query=query, phase=phase, k=s.args["k"],
                        runs=s.args["runs"], total=s.args["total"],
                        t0=s.t0))
    return sorted(out, key=lambda r: r["t0"])


def level_seconds(tracer) -> str:
    """Wall seconds of each generation / desummarize level span."""
    return ", ".join(f"{s.name}={s.seconds:.4f}" for s in tracer.spans
                     if s.name.startswith(("gfjs:level", "desummarize:level")))


def traced_call(fn, dev, tracer) -> dict:
    """One synchronized call of ``fn``: its result, wall seconds, and the
    bytes and seconds of the ``engine:upload`` / ``engine:download`` spans
    and the seconds of the ``gfjs:level:*`` spans it recorded."""
    since = len(tracer.spans)
    out, wall = timed(fn, dev)
    spans = tracer.spans[since:]

    def total(name, key):
        return sum(s.seconds if key == "s" else s.args.get(key, 0)
                   for s in spans if s.name.startswith(name))
    return dict(out=out, wall=wall,
                upload_bytes=total("engine:upload", "bytes"),
                download_bytes=total("engine:download", "bytes"),
                upload_s=total("engine:upload", "s"),
                download_s=total("engine:download", "s"),
                level_s=total("gfjs:level:", "s"),
                expand_launches=sum(s.name == "kernel:rle_expand_many"
                                    for s in spans),
                identity_levels=sum(bool(s.args.get("identity"))
                                    for s in spans
                                    if s.name.startswith("desummarize:")))


def fmt_call(name: str, c: dict) -> str:
    return (f"  {name} {c['wall']:.4f}s: engine:upload {c['upload_bytes']} B "
            f"({c['upload_s']:.4f}s), engine:download {c['download_bytes']} "
            f"B ({c['download_s']:.4f}s), expand_many calls "
            f"{c['expand_launches']}")


def plain(c: dict) -> dict:
    """A traced call's numbers, without its result (for ``--out``)."""
    return {k: v for k, v in c.items() if k != "out"}


def memo_free_copy(gfjs):
    """The same summary rebuilt from its levels, as storage or the numpy
    generator gives it: no device memo, so desummarize uploads it."""
    from repro_torch.core.gfjs import GFJS
    return GFJS(gfjs.levels, gfjs.column_order, gfjs.join_size,
                gfjs.domains)


def check_memo(gfjs, call: dict, what: str, host_bounds=()) -> None:
    """A desummarize on the memo: no upload, and no host prefix sums
    beyond ``host_bounds``, the levels whose ``GFJS.bounds`` a numpy path
    (``desummarize_range``) had made before the call."""
    check(call["upload_bytes"] == 0, f"{what} uploaded "
          f"{call['upload_bytes']} B")
    check(set(gfjs._bounds) == set(host_bounds),
          f"{what} ran a host np.cumsum")


def busy_share(fn, dev, wall: float) -> dict:
    """The card's busy seconds over one profiled call of ``fn`` (kernels
    plus copies, from the Chrome trace) against the wall seconds of an
    unprofiled call of it."""
    return busy_of(device_seconds(fn, dev), wall)


def busy_of(seconds: tuple, wall: float) -> dict:
    """``device_seconds``' (kernel s, copy s, ours) over ``wall``."""
    kern, copy, ours = seconds
    if kern is None:
        return dict(kernels=None, copies=None, share=None)
    return dict(kernels=kern, copies=copy, our_launches=ours,
                share=(kern + copy) / wall)


def fmt_busy(b: dict) -> str:
    if b["share"] is None:
        return "no device activity recorded"
    return (f"busy {b['share']:.4%} ({b['kernels']:.6f}s kernels, "
            f"{b['our_launches']} of ours, + {b['copies']:.6f}s copies)")


def run_a1(cat, query, dev, tracer) -> dict:
    """lastfm_A1 on the device, exactly against the numpy path."""
    import repro_torch
    from repro_torch.core.gfjs import desummarize as np_desummarize
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gj = repro_torch.GraphicalJoin(cat, query, device=dev, tracer=tracer)
    run = traced_call(gj.run, dev, tracer)
    gfjs, t_run = run["out"], run["wall"]
    aux = gfjs.aux_nbytes()
    peak_run = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    first = traced_call(lambda: gj.desummarize(gfjs, decode=False), dev,
                        tracer)
    check_memo(gfjs, first, "lastfm_A1 desummarize after run()")
    again = traced_call(lambda: gj.desummarize(gfjs, decode=False), dev,
                        tracer)
    check_memo(gfjs, again, "lastfm_A1 second desummarize")
    copy = memo_free_copy(gfjs)
    free = traced_call(lambda: gj.desummarize(copy, decode=False), dev,
                       tracer)
    codes = first["out"]
    for v in codes:
        check(torch.equal(codes[v], again["out"][v]), f"second {v}")
        check(torch.equal(codes[v], free["out"][v]), f"memo-free copy {v}")
    del again["out"], free["out"], copy
    want_codes = np_desummarize(gfjs, decode=False)
    for v in want_codes:
        check(np.array_equal(codes[v].cpu().numpy(), want_codes[v]),
              f"codes {v} vs numpy")
    del want_codes
    t_expand = first["wall"]
    host, t_d2h = timed(lambda: {v: c.cpu().numpy()
                                 for v, c in codes.items()}, dev)
    _, t_decode = timed(lambda: {v: gfjs.domains[v].decode(c)
                                 for v, c in host.items()}, dev)
    del codes, host, first["out"]
    values, t_full = timed(lambda: gj.desummarize(gfjs), dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    phases = {k: float(v) for k, v in gj.timings.items()}

    # the card's busy share of the main path: a second run() on a new
    # facade, and a desummarize on the memo
    again_gj = repro_torch.GraphicalJoin(cat, query, device=dev)
    busy = dict(run=busy_share(again_gj.run, dev, t_run),
                desummarize=busy_share(
                    lambda: gj.desummarize(gfjs, decode=False), dev,
                    t_expand))

    ref = repro_torch.GraphicalJoin(cat, query, device=dev,
                                    generation_backend="numpy")
    ref_gfjs, t_ref = timed(ref.run, dev)
    check(ref.plan().order == gj.plan().order, "plan order")
    check(gfjs.join_size == ref_gfjs.join_size == gj.join_size(),
          "join size")
    check(len(gfjs.levels) == len(ref_gfjs.levels), "level count")
    for la, lb in zip(gfjs.levels, ref_gfjs.levels):
        check(la.vars == lb.vars and np.array_equal(la.freq, lb.freq)
              and all(np.array_equal(la.key_cols[v], lb.key_cols[v])
                      for v in la.vars), f"level {la.vars} vs numpy")
    want = np_desummarize(ref_gfjs, decode=True)
    check(list(values) == list(want), "column order")
    for v in want:
        check(np.array_equal(values[v], want[v]), f"decoded column {v}")
    rows = gfjs.join_size
    print(f"lastfm_A1: |Q|={rows} x {len(values)} cols, order "
          f"{gj.plan().order}, runs/level "
          f"{[lvl.num_runs for lvl in gfjs.levels]}")
    print(f"  phases s: {json.dumps(phases)}")
    print(f"  run {t_run:.4f}s (numpy-generation run {t_ref:.4f}s, its "
          f"summarize {ref.timings['summarize']:.4f}s); summarize split: "
          f"gfjs:level:* spans {run['level_s']:.4f}s, engine:download "
          f"spans {run['download_s']:.4f}s ({run['download_bytes']} B), "
          f"engine:upload {run['upload_bytes']} B, expand_many calls "
          f"{run['expand_launches']}")
    print(f"  after run(): aux_nbytes {aux} (the device memo), peak device "
          f"bytes {peak_run}")
    for name, c in (("desummarize after run()", first), ("again", again),
                    ("on a memo-free copy", free)):
        print(fmt_call(name, c) + f", identity levels "
              f"{c['identity_levels']}")
    print(f"  desummarize D2H {t_d2h:.4f}s, decode {t_decode:.4f}s, full "
          f"decode=True {t_full:.4f}s; all three calls' codes equal "
          f"(torch.equal) and equal to numpy")
    print(f"  rows/s: device expansion {rows / t_expand:.6g}, "
          f"full {rows / t_full:.6g}; peak device bytes {peak}")
    print(f"  card: run() {fmt_busy(busy['run'])}; desummarize "
          f"{fmt_busy(busy['desummarize'])}")
    print(f"  level spans s: {level_seconds(tracer)}")
    print("  exact against the numpy path: GFJS levels and decoded columns")
    return dict(gfjs=gfjs, rows=rows, t_run=t_run, t_expand=t_expand,
                t_d2h=t_d2h, t_decode=t_decode, t_full=t_full, peak=peak,
                peak_run=peak_run, aux_nbytes=aux, run=plain(run),
                first=plain(first), again=plain(again), memo_free=plain(free),
                busy=busy, phases=phases, t_numpy_run=t_ref,
                numpy_summarize=float(ref.timings["summarize"]))


def staged_download(t: torch.Tensor, dtype) -> np.ndarray:
    """The engine's staged download on one host thread: two reused pinned
    buffers of ``STAGE_BYTES``, the card copying one chunk while the host
    moves the one before out of its buffer (widening it on the way)."""
    from repro_torch.core.engine import STAGE_BYTES
    n = t.numel()
    out = np.empty(n, dtype)
    chunk = STAGE_BYTES // t.element_size()
    bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8,
                        pin_memory=True).view(t.dtype) for _ in range(2)]
    done = [torch.cuda.Event(), torch.cuda.Event()]

    def copy_chunk(i):
        lo = i * chunk
        m = min(chunk, n - lo)
        bufs[i % 2][:m].copy_(t[lo:lo + m], non_blocking=True)
        done[i % 2].record()
    chunks = -(-n // chunk)
    if chunks:
        copy_chunk(0)
    for i in range(chunks):
        if i + 1 < chunks:
            copy_chunk(i + 1)
        done[i % 2].synchronize()
        lo = i * chunk
        m = min(chunk, n - lo)
        np.copyto(out[lo:lo + m], bufs[i % 2][:m].numpy())
    return out


def threaded_download(t: torch.Tensor, pool, threads: int) -> np.ndarray:
    """A 1-D card tensor to a new numpy array of its dtype, pageable, one
    slice for each of ``pool``'s ``threads``."""
    n = t.numel()
    out = np.empty(n, torch.empty(0, dtype=t.dtype).numpy().dtype)
    host = torch.from_numpy(out)
    step = -(-n // threads) if n else 1
    list(pool.map(lambda lo: host[lo:lo + step].copy_(t[lo:lo + step]),
                  range(0, n, step)))
    return out


def download_routes(codes: torch.Tensor, dev) -> dict:
    """Seconds of the routes that bring int32 device codes home as int64
    numpy (the ``LevelSummary`` contract), and an int64 array (the run
    lengths) home, the engine's ``_download`` among them; each result
    checked against the first."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import engine
    threads = engine.STAGE_THREADS
    mb = engine.STAGE_BYTES >> 20
    pool = ThreadPoolExecutor(threads)
    want = None
    out = {}
    wide = None
    routes = {
        "int32: widen on the card, pageable download":
            lambda: codes.to(torch.int64).cpu().numpy(),
        "int32: pageable download, widen on the host (the parent's)":
            lambda: codes.cpu().numpy().astype(np.int64),
        f"int32: pinned 2 x {mb} MB staging, widen on 1 host thread":
            lambda: staged_download(codes, np.int64),
        f"int32: engine._download, pinned 2 x {mb} MB staging, widen on "
        f"{threads} host threads": lambda: engine._download(codes, np.int64),
        f"int32: widen on the card, pageable download on {threads} threads":
            lambda: threaded_download(codes.to(torch.int64), pool, threads),
        "int64: pageable download (the parent's)":
            lambda: wide.cpu().numpy(),
        f"int64: engine._download, pinned 2 x {mb} MB staging, {threads} "
        f"host threads": lambda: engine._download(wide),
    }
    for name, fn in routes.items():
        if name.startswith("int64") and wide is None:
            wide = codes.to(torch.int64)
        got, t = timed(fn, dev)
        if want is None:
            want = got
        else:
            check(np.array_equal(got, want), f"download route {name}")
        del got
        out[name] = t
    pool.shutdown()
    return out


def run_a2(cat, query, dev, tracer) -> dict:
    """lastfm_A2 on the device; codes stay there; windows vs numpy; the
    memoized, repeated and memo-free desummarize equal."""
    import repro_torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gj = repro_torch.GraphicalJoin(cat, query, device=dev, tracer=tracer)
    run = traced_call(gj.run, dev, tracer)
    gfjs, t_run = run["out"], run["wall"]
    aux = gfjs.aux_nbytes()
    peak_run = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    rows = gfjs.join_size
    check(rows == gj.join_size() == gj.generator.join_size, "join size")
    deepest = gfjs._launch[len(gfjs.levels) - 1][1][1][0]
    routes = download_routes(deepest, dev)
    del deepest

    rng = np.random.default_rng(1)
    starts = [0, rows // 2, max(rows - 4096, 0)] + \
        [int(x) for x in rng.integers(0, max(rows - 4096, 1), 3)]

    def check_columns(codes, what):
        check(list(codes) == list(gfjs.column_order), f"{what}: order")
        for v, c in codes.items():
            check(c.shape == (rows,) and c.device.type == dev.type,
                  f"{what} column {v}: {tuple(c.shape)} on {c.device}")
        for lo in starts:
            hi = min(lo + 4096, rows)
            win = gj.desummarize_range(gfjs, lo, hi, decode=False)
            for v in win:
                check(np.array_equal(codes[v][lo:hi].cpu().numpy(), win[v]),
                      f"{what}: window [{lo},{hi}) of {v}")
        return {v: int(c.sum(dtype=torch.int64)) for v, c in codes.items()}

    first = traced_call(lambda: gj.desummarize(gfjs, decode=False), dev,
                        tracer)
    check_memo(gfjs, first, "lastfm_A2 desummarize after run()")
    t_expand = first["wall"]
    sums = check_columns(first.pop("out"), "after run()")
    # the first columns go before the second call: the peak stays that of
    # one set of columns beside the memo
    host_bounds = set(gfjs._bounds)
    again = traced_call(lambda: gj.desummarize(gfjs, decode=False), dev,
                        tracer)
    check_memo(gfjs, again, "lastfm_A2 second desummarize", host_bounds)
    check(check_columns(again["out"], "again") == sums,
          "second desummarize's column sums")
    copy = memo_free_copy(gfjs)
    free = traced_call(lambda: gj.desummarize(copy, decode=False), dev,
                       tracer)
    for v in gfjs.column_order:
        check(torch.equal(free["out"][v], again["out"][v]),
              f"memo-free copy {v}")
    del again["out"], free["out"], copy
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    phases = {k: float(v) for k, v in gj.timings.items()}
    print(f"lastfm_A2: |Q|={rows} x {len(gfjs.column_order)} cols, order "
          f"{gj.plan().order}, runs/level "
          f"{[lvl.num_runs for lvl in gfjs.levels]}")
    print(f"  phases s: {json.dumps(phases)}")
    print(f"  run {t_run:.4f}s; summarize split: gfjs:level:* spans "
          f"{run['level_s']:.4f}s, engine:download spans "
          f"{run['download_s']:.4f}s ({run['download_bytes']} B), "
          f"engine:upload {run['upload_bytes']} B, expand_many calls "
          f"{run['expand_launches']}")
    print(f"  after run(): aux_nbytes {aux} (the device memo), peak device "
          f"bytes {peak_run}")
    print("  download routes of the deepest level's codes "
          f"({gfjs.levels[-1].num_runs} int32), s: " + ", ".join(
              f"{k} {v:.4f}" for k, v in routes.items()))
    for name, c in (("desummarize after run()", first), ("again", again),
                    ("on a memo-free copy", free)):
        print(fmt_call(name, c) + f" ({rows / c['wall']:.6g} rows/s), "
              f"identity levels {c['identity_levels']}")
    print(f"  peak device bytes {peak}")
    print(f"  level spans s: {level_seconds(tracer)}")
    print(f"  {len(starts)} windows of the first and second calls exact "
          f"against numpy desummarize_range; the memo-free copy's columns "
          f"equal the second call's (torch.equal)")
    return dict(gfjs=gfjs, rows=rows, t_run=t_run, t_expand=t_expand,
                peak=peak, peak_run=peak_run, aux_nbytes=aux, run=plain(run),
                first=plain(first), again=plain(again), memo_free=plain(free),
                download_routes=routes, phases=phases)


# -- phase 6: the summary side ----------------------------------------------

def same(got, want, what: str) -> None:
    """Integers exactly, floats to rtol 1e-12, dicts column by column."""
    if isinstance(want, dict):
        check(list(got) == list(want), f"{what}: columns {list(got)}")
        for k in want:
            same(got[k], want[k], f"{what}[{k}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    check(g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}")
    if g.dtype.kind == "f" or w.dtype.kind == "f":
        check(np.allclose(g, w, rtol=1e-12, atol=0), f"{what}: beyond rtol")
    else:
        check(np.array_equal(g, w), f"{what}: differs")


OUR_KERNELS = ("segsum_pass", "boundaries_kernel", "expand_many_kernel")


def profiled_events(fn, dev, cpu: bool = True):
    """The Chrome-trace events torch.profiler records over one call of
    ``fn`` (None if the profiler fails: a measurement, not a check).
    ``cpu=False`` records the card's activity only, which keeps the trace
    of a call that launches ~10^5 kernels short to export and read."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    try:
        with profile(activities=acts, acc_events=True) as prof:
            with record_function("aggregate"):
                fn()
            sync(dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            return json.loads(path.read_text())["traceEvents"]
    except RuntimeError as exc:
        print(f"  torch.profiler failed: {exc}")
        return None


def device_seconds(fn, dev):
    """(kernel s, copy s, launches of our kernels) that torch.profiler
    records on the card over one call of ``fn``, read from its Chrome
    trace: the kernels launched through ctypes belong to no PyTorch op,
    so only the trace's CUPTI records (not ``prof.events()``) hold them.
    (None, None, 0) where it records no device activity."""
    return event_seconds(profiled_events(fn, dev))


def event_seconds(events):
    """``device_seconds`` of a profiled call's trace events."""
    if events is None:
        return None, None, 0
    kern = copy = 0.0
    ours = 0
    for e in events:
        cat = e.get("cat")
        if cat == "kernel":
            kern += e.get("dur", 0)
            ours += any(k in e.get("name", "") for k in OUR_KERNELS)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copy += e.get("dur", 0)
    if kern == 0 and copy == 0:
        return None, None, 0
    return kern / 1e6, copy / 1e6, ours


def split_call(fn, dev, tracers):
    """One call on the card: (result, seconds split).  ``upload`` and
    ``download`` sum the engine's transfer spans (a download also waits
    for the kernels before it); ``host`` is the rest of the wall time;
    ``kernels`` / ``copies`` are the card's own busy times in a second,
    profiled call (``our_launches``: how many of its kernel records are
    this repository's kernels)."""
    from repro_torch.obs.trace import Tracer
    tr = Tracer()
    tracers.append(tr)

    def call():
        with tr.span("aggregate"):
            return fn()
    out, wall = timed(call, dev)
    up = sum(sp.seconds for sp in tr.find("engine:upload"))
    down = sum(sp.seconds for sp in tr.find("engine:download"))
    kern, copy, ours = device_seconds(fn, dev)
    return out, dict(wall=wall, upload=up, download=down,
                     host=wall - up - down, kernels=kern, copies=copy,
                     our_launches=ours)


def split_aggregate(gj, args, kw, gfjs, dev, tracers):
    """``gj.aggregate`` on the card, split as :func:`split_call`."""
    return split_call(lambda: gj.aggregate(*args, gfjs=gfjs, **kw), dev,
                      tracers)


def fmt_split(t: dict) -> str:
    dev = "no device activity recorded" if t["kernels"] is None else \
        (f"{t['kernels']:.6f}s kernels ({t['our_launches']} of ours) + "
         f"{t['copies']:.6f}s copies")
    return (f"{t['wall']:.4f}s = host {t['host']:.4f} + upload "
            f"{t['upload']:.4f} + download/wait {t['download']:.4f}; "
            f"card: {dev}")


def run_summary(cat, queries, a1, a2, dev, tracers, answers) -> dict:
    """Phase 6: aggregates from the GFJS and build_factor on the card.
    Each query's ``(name, args, kw, answer)`` go into ``answers`` (phase
    10 holds the sharded frames against them)."""
    import tempfile
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.core.potentials import Factor
    from repro_torch.obs.trace import Tracer
    gfjs = a1["gfjs"]
    gj = repro_torch.GraphicalJoin(cat, queries["lastfm_A1"], device=dev)
    cpu = repro_torch.GraphicalJoin(cat, queries["lastfm_A1"], device="cpu")
    per_user = cpu.aggregate("count", by=["U1"], gfjs=gfjs)
    top = per_user["U1"][int(np.argmax(per_user["count"]))]
    specs = [("count", ("count",), {}),
             ("count by U1,A2", ("count",), dict(by=["U1", "A2"])),
             ("count by A1", ("count",), dict(by=["A1"])),
             ("sum U2", ("sum", "U2"), {}),
             ("mean U2", ("mean", "U2"), {}),
             (f"count by A2 where U1={top}", ("count",),
              dict(by=["A2"], where={"U1": top}))]
    out = {"lastfm_A1": {}, "lastfm_A2": {}}
    results = {}
    print(f"summary side, lastfm_A1 (runs/level "
          f"{[lvl.num_runs for lvl in gfjs.levels]}):")
    for name, args, kw in specs:
        got, t = split_aggregate(gj, args, kw, gfjs, dev, tracers)
        want, t_cpu = timed(lambda: cpu.aggregate(*args, gfjs=gfjs, **kw),
                            dev)
        same(got, want, name)
        results[name] = got
        t["cpu_wall"] = t_cpu
        out["lastfm_A1"][name] = t
        print(f"  {name}: {fmt_split(t)}; device='cpu' {t_cpu:.4f}s; "
              f"equal")
    answers["lastfm_A1"] = [(name, args, kw, results[name])
                            for name, args, kw in specs]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "lastfm_A1.gfjs")
        nbytes, t_store = timed(lambda: gj.store(gfjs, path), dev)
        back, t_load = timed(lambda: repro_torch.GraphicalJoin.load(path),
                             dev)
    name = "store -> load -> count by U1,A2"
    got, t = split_aggregate(gj, ("count",), dict(by=["U1", "A2"]), back,
                             dev, tracers)
    same(got, results["count by U1,A2"], name)
    t.update(store=t_store, load=t_load, file_bytes=nbytes)
    out["lastfm_A1"][name] = t
    print(f"  {name}: store {t_store:.4f}s ({nbytes} B), load "
          f"{t_load:.4f}s, aggregate {fmt_split(t)}; equal")
    del back

    # GROUP BY COUNT on the card over the desummarized rows
    codes = gj.desummarize(gfjs, decode=False)
    cols = {v: codes[v].cpu().numpy() for v in ("U1", "A2")}
    del codes
    sizes = {v: gfjs.domains[v].size for v in cols}
    tr = Tracer()
    tracers.append(tr)

    def build():
        with tr.span("build_factor"):
            return engine.build_factor(cols, sizes, device=dev)
    fac, t_bf = timed(build, dev)
    ref, t_np = timed(lambda: Factor.from_columns(cols, sizes), dev)
    check(np.array_equal(fac.keys, ref.keys)
          and np.array_equal(fac.bucket, ref.bucket),
          "build_factor vs Factor.from_columns")
    by = results["count by U1,A2"]
    check(np.array_equal(gfjs.domains["U1"].decode(fac.keys[:, 0]), by["U1"])
          and np.array_equal(gfjs.domains["A2"].decode(fac.keys[:, 1]),
                             by["A2"])
          and np.array_equal(fac.bucket, by["count"]),
          "build_factor vs the summary's GROUP BY U1, A2")
    rows = len(cols["U1"])
    out["build_factor"] = dict(rows=rows, groups=len(fac.bucket),
                               seconds=t_bf, numpy_seconds=t_np)
    print(f"  build_factor over {rows} desummarized (U1, A2) rows: "
          f"{len(fac.bucket)} groups in {t_bf:.4f}s on the card "
          f"(Factor.from_columns {t_np:.4f}s); equal to from_columns and to "
          f"the summary's GROUP BY U1, A2")
    del cols, fac, ref

    g2 = a2["gfjs"]
    gj2 = repro_torch.GraphicalJoin(cat, queries["lastfm_A2"], device=dev)
    cpu2 = repro_torch.GraphicalJoin(cat, queries["lastfm_A2"],
                                     device="cpu")
    print(f"summary side, lastfm_A2 (runs/level "
          f"{[lvl.num_runs for lvl in g2.levels]}):")
    answers["lastfm_A2"] = []
    for name, args, kw in (("count", ("count",), {}),
                           ("sum A2", ("sum", "A2"), {}),
                           ("count by A2", ("count",), dict(by=["A2"]))):
        got, t = split_aggregate(gj2, args, kw, g2, dev, tracers)
        want, t_cpu = timed(lambda: cpu2.aggregate(*args, gfjs=g2, **kw),
                            dev)
        same(got, want, f"lastfm_A2 {name}")
        answers["lastfm_A2"].append((name, args, kw, got))
        t["cpu_wall"] = t_cpu
        out["lastfm_A2"][name] = t
        print(f"  {name}: {fmt_split(t)}; device='cpu' {t_cpu:.4f}s; equal")
    return out


# -- phase 7: the kernel API and the dense message path -----------------------

def friends_potential(cat, parent: str, child: str):
    """Phi(parent, child) = Factor.from_columns of user_friends (user ids
    are already codes 0..n-1), and the per-user artist counts m_ua."""
    from repro_torch.core.potentials import Factor
    uf, ua = cat["user_friends"].columns, cat["user_artists"].columns
    n = int(max(uf["userID"].max(), uf["friendID"].max(),
                ua["userID"].max())) + 1
    phi = Factor.from_columns({parent: uf["userID"], child: uf["friendID"]},
                              {parent: n, child: n})
    return phi, np.bincount(ua["userID"], minlength=n).astype(np.int64)


def dense_split(phi, child, msg, dev) -> dict:
    """Seconds of each step of one ``maybe_dense_message``, each ended by a
    synchronize: host (the reference's declines and the COO cell index),
    upload, densify (scatter into the [P, V] int32 matrix), kernel,
    download."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    host, t_host = timed(lambda: engine.dense_inputs(phi, child, msg), dev)
    P, V, flat, vals, m = host
    up, t_up = timed(lambda: engine._uploads(
        dev, (flat, np.int64), (vals, np.int32), (m, np.int32)), dev)
    dense, t_dense = timed(lambda: engine.densify(P, V, up[0], up[1]), dev)
    out, t_kernel = timed(lambda: ops.dense_message(dense, up[2].view(V, 1)),
                          dev)
    _, t_down = timed(lambda: out.cpu().numpy(), dev)
    return dict(host=t_host, upload=t_up, densify=t_dense, kernel=t_kernel,
                download=t_down)


def run_dense_and_api(cat, queries, a1, a2, dev, tracers) -> dict:
    """Phase 7: the join sizes of phases 4-5 through the dense kernel, the
    single-column expansion over lastfm_A1's widest level, and a second
    desummarize on memoized bounds."""
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import expand_gather_ref
    from repro_torch.obs.trace import Tracer
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import numpy_message
    tr = Tracer()
    tracers.append(tr)
    (phi12, m_ua), t_phi = timed(
        lambda: friends_potential(cat, "U1", "U2"), dev)
    phi23, _ = friends_potential(cat, "U2", "U3")
    P = phi12.sizes[0]
    print(f"dense message path: Phi(U1, U2) {P} x {phi12.sizes[1]} "
          f"({phi12.num_entries} cells) built in {t_phi:.4f}s")

    def message(phi, child, msg, what):
        with tr.span(f"message:{what}"):
            out, t = timed(lambda: engine.maybe_dense_message(
                phi, child, msg, device=dev), dev)
        check(out is not None, f"{what}: maybe_dense_message declined")
        want = numpy_message(phi, child, msg)
        check(out.dtype == np.int64 and np.array_equal(out, want),
              f"{what}: differs from the numpy route")
        return out, t

    m1, t_a1 = message(phi12, "U2", m_ua, "A1 m(U1)")
    size_a1 = int(m1 @ m_ua)
    check(size_a1 == a1["rows"], f"lastfm_A1 by messages {size_a1} vs "
          f"{a1['rows']}")
    m2, t_a2a = message(phi23, "U3", m_ua, "A2 m(U2)")
    m12, t_a2b = message(phi12, "U2", m2, "A2 m(U1)")
    size_a2 = int(m12 @ m_ua)
    check(size_a2 == a2["rows"], f"lastfm_A2 by messages {size_a2} vs "
          f"{a2['rows']}")
    print(f"  lastfm_A1 = sum m1 * m_ua = {size_a1} ({t_a1:.4f}s); "
          f"lastfm_A2 = {size_a2} ({t_a2a:.4f}s + {t_a2b:.4f}s); each "
          f"message equal to the numpy route, each sum to phases 4-5")

    gfjs = a1["gfjs"]
    gj = repro_torch.GraphicalJoin(cat, queries["lastfm_A1"], device=dev,
                                   tracer=tr)
    gfjs._launch.clear()            # run() filled the memo already
    first, t_first = timed(lambda: gj.desummarize(gfjs, decode=False), dev)
    entries = dict(gfjs._launch)
    check(sorted(entries) == list(range(len(gfjs.levels))),
          f"memoized levels {sorted(entries)}")
    second, t_second = timed(lambda: gj.desummarize(gfjs, decode=False), dev)
    check(all(gfjs._launch[lv] is e for lv, e in entries.items())
          and len(gfjs._launch) == len(entries),
          "the second desummarize made new launch metadata")
    for v in first:
        check(torch.equal(first[v], second[v]), f"second desummarize {v}")
    del second
    print(f"  desummarize lastfm_A1 after clearing the memo: first "
          f"{t_first:.4f}s (uploads the levels and fills the memo), second "
          f"{t_second:.4f}s (reuses {len(entries)} levels' device codes and "
          f"bounds, {gfjs.aux_nbytes()} B); equal columns")

    li = next(i for i, lv in enumerate(gfjs.levels) if "A2" in lv.vars)
    lvl, total = gfjs.levels[li], gfjs.join_size
    payload = torch.from_numpy(lvl.key_cols["A2"].astype(np.int32)).to(dev)
    meta = ops.gfjs_expand_meta(gfjs, li, dev)
    with tr.span("rle_expand:A2"):
        col, t_col = timed(lambda: ops.rle_expand(payload, None, total,
                                                  meta=meta), dev)
    check(torch.equal(col, first["A2"]), "rle_expand A2 vs expand_many's")
    check(torch.equal(col, expand_gather_ref(payload, meta, total)),
          "rle_expand A2 vs the plain version")
    del col, first
    with tr.span("expand_indices"):
        idx, t_idx = timed(lambda: ops.expand_indices(meta, total), dev)
    runs = torch.arange(lvl.num_runs, dtype=torch.int32, device=dev)
    check(torch.equal(idx, expand_gather_ref(runs, meta, total)),
          "expand_indices vs the plain version")
    del idx
    print(f"  rle_expand of A2 over level {li} ({lvl.num_runs} runs -> "
          f"{total} rows) {t_col:.4f}s, equal to phase 4's column and the "
          f"plain version; expand_indices {t_idx:.4f}s, equal to the plain "
          f"version")
    return dict(join_sizes=dict(lastfm_A1=size_a1, lastfm_A2=size_a2),
                seconds=dict(phi=t_phi, a1=t_a1, a2=[t_a2a, t_a2b],
                             desummarize_first=t_first,
                             desummarize_second=t_second,
                             rle_expand=t_col, expand_indices=t_idx),
                _split_args=(phi12, m_ua))


# -- phase 8: kernels at the paths' shapes -----------------------------------

def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int):
    """Per-call ms of ``reps`` calls of ``fn`` captured in one CUDA graph
    and replayed twice: the card's time without the host's cost of each
    launch (which bounds a per-call loop of kernels shorter than it).
    None, and said so, where the capture fails."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:        # a measurement, not a check
        print(f"  CUDA graph capture failed: {exc}")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (2 * reps)


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}ms"


def beside(before) -> str:
    """A redesigned kernel's time under its previous design, printed beside
    its new one."""
    return "" if before is None else f", previous design {before:.4f}ms"


def shape_inputs(shape, gfjs, dev, seed):
    """The launch's inputs: the real GFJS level for a desummarize launch,
    seeded inputs of the recorded (K, runs, total) for a generation one."""
    k, runs, total = shape["k"], shape["runs"], shape["total"]
    if shape["phase"] == "desummarize" and gfjs is not None:
        lvl = next(lv for lv in gfjs.levels
                   if lv.num_runs == runs and len(lv.vars) == k)
        payloads = torch.from_numpy(np.stack(
            [lvl.key_cols[v] for v in lvl.vars]).astype(np.int32)).to(dev)
        bounds = torch.from_numpy(
            np.cumsum(lvl.freq).astype(np.int32)).to(dev)
        return payloads, bounds
    gen = torch.Generator(device=dev).manual_seed(seed)
    cuts = torch.randint(0, total + 1, (runs - 1,), generator=gen,
                         device=dev, dtype=torch.int64).sort().values
    bounds = torch.cat([cuts, torch.tensor([total], device=dev)]) \
        .to(torch.int32)
    payloads = torch.randint(0, 1 << 30, (k, runs), generator=gen,
                             device=dev, dtype=torch.int32)
    return payloads, bounds


def measure_shape(shape, gfjs, dev, seed) -> dict:
    """One expand_many launch shape: exact against the plain version, then
    timed (CUDA events) beside its HBM bound, the plain version and
    ``repeat_interleave``."""
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.ref import expand_many_ref
    k, runs, total = shape["k"], shape["runs"], shape["total"]
    payloads, bounds = shape_inputs(shape, gfjs, dev, seed)
    want = expand_many_ref(payloads, bounds, total)
    got = expand_many(payloads, bounds, total)
    err = max_abs_err(got, want)
    check(err == 0, f"kernel vs plain at {shape}: {err}")
    del got, want
    counts = torch.diff(bounds.long(), prepend=torch.zeros(
        1, dtype=torch.int64, device=dev))
    reps = 20 if k * total < (1 << 28) else 5
    ms = cuda_ms(lambda: expand_many(payloads, bounds, total), reps)
    # the launches a host can issue faster than the card runs them (a
    # graph holds every output of its calls, so not the large ones)
    graph = graph_ms(lambda: expand_many(payloads, bounds, total), reps) \
        if k * total <= 1 << 24 else None
    plain_ms = cuda_ms(lambda: expand_many_ref(payloads, bounds, total), reps)
    library_ms = cuda_ms(lambda: torch.repeat_interleave(
        payloads, counts, dim=1, output_size=total), reps)
    nbytes = (k * total + k * runs + runs) * 4
    row = dict(shape, max_abs_err=err, ms=ms, graph_ms=graph, plain_ms=plain_ms, library_ms=library_ms,
               bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    row.pop("t0", None)
    print(f"  {shape['query']} {shape['phase']:<11s} K={k} runs={runs} "
          f"total={total}: kernel {ms:.4f}ms ({fmt_ms(graph)} in a CUDA "
          f"graph), bound {row['bound_ms']:.4f}ms "
          f"({row['bound_ms'] / ms:.3f} of bound), plain {plain_ms:.4f}ms, "
          f"repeat_interleave {library_ms:.4f}ms")
    return row


def summary_shapes(tracers) -> dict:
    """(kernel, n, segments or key bytes, dtype) -> launches, from the
    ``kernel:`` spans of phase 6 (empty inputs launch nothing)."""
    shapes: dict = {}
    for tr in tracers:
        for sp in tr.spans:
            a = sp.args
            if sp.name == "kernel:mul_segsum" and a["n"]:
                key = ("mul_segsum", a["n"], a["segments"], a["dtype"])
            elif sp.name == "kernel:run_boundaries" and a["n"]:
                key = ("run_boundaries", a["n"], a["key_bytes"], None)
            else:
                continue
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def measure_summary_shape(key, launches, dev, seed) -> dict:
    """One phase-6 launch shape on seeded inputs: exact against the plain
    version, then timed (CUDA events) beside its HBM bound, the plain
    version and, for mul_segsum, ``index_add_`` on the product."""
    from repro_torch.kernels.mul_segsum import mul_segsum
    from repro_torch.kernels.ref import mul_segsum_ref, run_boundaries_ref
    from repro_torch.kernels.run_boundaries import run_boundaries
    kernel, n, third, dtype = key
    gen = torch.Generator(device=dev).manual_seed(seed)
    reps = 20 if n < (1 << 24) else 10
    if kernel == "mul_segsum":
        s = third
        acc = torch.float64 if dtype == "float64" else torch.int64
        seg = torch.randint(0, s, (n,), generator=gen, device=dev,
                            dtype=torch.int32).sort().values
        # integral values: float sums are exact, so the check is too
        x = torch.randint(-1000, 1000, (n,), generator=gen, device=dev,
                          dtype=torch.int64).to(acc)
        y = torch.randint(0, 9, (n,), generator=gen, device=dev,
                          dtype=torch.int64).to(acc)
        got, want = mul_segsum(seg, x, y, s), mul_segsum_ref(seg, x, y, s)
        fn = lambda: mul_segsum(seg, x, y, s)                # noqa: E731
        plain = lambda: mul_segsum_ref(seg, x, y, s)         # noqa: E731
        library = lambda: torch.zeros(                       # noqa: E731
            s, dtype=acc, device=dev).index_add_(0, seg, x * y)
        nbytes = n * 4 + 2 * n * 8 + s * 8
        label = f"n={n} segments={s} {dtype}"
    else:
        kdt = torch.int32 if third == 4 else torch.int64
        keys = torch.randint(0, max(n // 4, 1), (n,), generator=gen,
                             device=dev, dtype=kdt).sort().values
        got, want = run_boundaries(keys), run_boundaries_ref(keys)
        fn = lambda: run_boundaries(keys)                    # noqa: E731
        plain = lambda: run_boundaries_ref(keys)             # noqa: E731
        library = None
        nbytes = n * (third + 4)
        label = f"n={n} keys int{8 * third}"
    err = float((got - want).abs().max())
    check(err == 0, f"{kernel} vs plain at {label}: {err}")
    del got, want
    ms = cuda_ms(fn, reps)
    plain_ms = cuda_ms(plain, reps)
    library_ms = cuda_ms(library, reps) if library is not None else None
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lib = "n/a" if library_ms is None else f"{library_ms:.4f}ms"
    print(f"  {kernel} {label} (x{launches}): kernel {ms:.4f}ms, bound "
          f"{bound_ms:.4f}ms ({bound_ms / ms:.3f} of bound), plain "
          f"{plain_ms:.4f}ms, library {lib}")
    return dict(kernel=kernel, n=n, third=third, dtype=dtype,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
                bound_ms=bound_ms, bound_by="bytes")


def counts_instr_per_mac() -> float:
    """SASS instructions per 32 x 32 -> 64-bit multiply-add in the counts
    instantiation of dense_message's tiled kernel (``IMAD.WIDE``, signed;
    the unsigned ones compute addresses), from ``cuobjdump -sass`` of the
    built library; 1.0, and said so, where cuobjdump cannot be run."""
    import re
    from repro_torch.kernels import build
    lib = build.load("dense_message")._name
    tool = Path(build._nvcc()).with_name("cuobjdump")
    try:
        sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"  cuobjdump failed ({exc}): taking 1 instruction per "
              f"multiply-add")
        return 1.0
    body = next(f for f in sass.split("Function : ")[1:]
                if "dense_message_kernel" in f.split()[0]
                and "Counts" in f.split()[0])
    n = len(re.findall(r"\bIMAD\.WIDE ", body))
    print(f"  SASS of the counts kernel: {n} IMAD.WIDE for "
          f"{DENSE_MACS_PER_STEP} multiply-adds per unrolled step")
    return n / DENSE_MACS_PER_STEP


def message_rates(dev) -> dict:
    """The counts path's peak: int32 multiply-adds per second (the guide's
    rate per SM x SMs x the card's maximum SM clock from nvidia-smi) and
    the SASS instructions each 64-bit multiply-add takes."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = float(smi.stdout.split()[0]) * 1e6
    return dict(instr_per_mac=counts_instr_per_mac(), sms=sms,
                clock_hz=clock,
                imad_per_s=IMAD_PER_CLOCK_PER_SM * sms * clock)


def message_shapes(tracers) -> dict:
    """(kernel, shape...) -> launches, from phase 7's ``kernel:`` spans."""
    shapes: dict = {}
    for tr in tracers:
        for sp in tr.spans:
            a = sp.args
            if sp.name == "kernel:dense_message" and a["p"] * a["k"]:
                key = ("dense_message", a["p"], a["v"], a["k"], a["dtype"])
            elif sp.name == "kernel:rle_expand" and a["total"]:
                key = ("expand_gather", a["runs"], a["total"], a["dtype"])
            else:
                continue
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def measure_dense_shape(p, v, k, dtype, launches, dev, seed, rates,
                        cold=False) -> dict:
    """dense_message at [p, v] @ [v, k] on seeded counts in [0, 100):
    exact against the plain version, then timed beside its bound (the
    larger of HBM bytes and multiply-adds at the type's rate), the plain
    version and ``torch.matmul`` (TF32 off; for counts, on float64 copies,
    the nearest library call, exact only while sums stay below 2^53).
    Kernel and library are timed per call (CUDA events around a loop of
    calls) and in a CUDA graph, warm (one phi, which L2 holds) and, with
    ``cold``, rotating over copies of phi that together pass twice the
    L2, so each call reads its phi from HBM."""
    from repro_torch.kernels.dense_message import THIN_K, dense_message
    from repro_torch.kernels.ref import dense_message_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.int32 if dtype == "int32" else torch.float32
    phi = torch.randint(0, 100, (p, v), generator=gen, device=dev,
                        dtype=torch.int32).to(dt)
    m = torch.randint(0, 100, (v, k), generator=gen, device=dev,
                      dtype=torch.int32).to(dt)
    got, want = dense_message(phi, m), dense_message_ref(phi, m)
    err = dense_err(got, want)
    check(err == 0, f"dense_message vs plain at [{p},{v}]@[{v},{k}] "
          f"{dtype}: {err}")
    del got, want
    counts = dt == torch.int32
    reps = 20
    ms = cuda_ms(lambda: dense_message(phi, m), reps)
    graph = graph_ms(lambda: dense_message(phi, m), reps)
    plain_ms = cuda_ms(lambda: dense_message_ref(phi, m), reps)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cold_row = None
    try:
        if counts:
            a, b = phi.double(), m.double()
            lib_name = "float64 torch.matmul"
        else:
            a, b = phi, m
            lib_name = "torch.matmul, TF32 off"
        library_ms = cuda_ms(lambda: torch.matmul(a, b), reps)
        library_graph = graph_ms(lambda: torch.matmul(a, b), reps)
        if cold:
            l2 = getattr(torch.cuda.get_device_properties(dev),
                         "L2_cache_size", 0) or L2_BYTES
            copies = -(-2 * l2 // (phi.numel() * phi.element_size())) + 1
            phis = itertools.cycle([phi.clone() for _ in range(copies)])
            kern = lambda: dense_message(next(phis), m)  # noqa: E731
            cold_ms = cuda_ms(kern, 3 * copies)
            cold_graph = graph_ms(kern, 3 * copies)
            libs = itertools.cycle([phi.to(a.dtype, copy=True)
                                    for _ in range(copies)])
            lib = lambda: torch.matmul(next(libs), b)  # noqa: E731
            cold_lib = cuda_ms(lib, 3 * copies)
            cold_lib_graph = graph_ms(lib, 3 * copies)
            del phis, libs
            cold_row = dict(copies=copies, l2_bytes=l2, ms=cold_ms,
                            graph_ms=cold_graph, library_ms=cold_lib,
                            library_graph_ms=cold_lib_graph)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    nbytes = (p * v + v * k) * 4 + p * k * (8 if counts else 4)
    macs = p * v * k
    ops_ms = (macs * rates["instr_per_mac"] / rates["imad_per_s"] if counts
              else 2 * macs / FP32_FLOP_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    label = f"[{p},{v}]@[{v},{k}] {'counts' if counts else 'float32'}"
    path = "thin" if k <= THIN_K else "tiled"
    key = ("dense_message", p, v, k, dtype)
    before = PREVIOUS_MS.get(key)
    print(f"  dense_message {label} (x{launches}, {path} kernel): kernel "
          f"{ms:.4f}ms per call, {fmt_ms(graph)} in a CUDA graph; bound "
          f"{bound_ms:.4f}ms by {bound_by} ({bound_ms / ms:.3f} of bound per "
          f"call; bytes {bytes_ms:.4f}ms, operations {ops_ms:.4f}ms), plain "
          f"{plain_ms:.4f}ms, {lib_name} {library_ms:.4f}ms per call, "
          f"{fmt_ms(library_graph)} in a graph{beside(before)}")
    if cold_row is not None:
        c = cold_row
        share = "" if c["graph_ms"] is None else \
            f" ({bytes_ms / c['graph_ms']:.3f} of the HBM bound)"
        print(f"    cold, over {c['copies']} copies of phi: kernel "
              f"{c['ms']:.4f}ms per call, {fmt_ms(c['graph_ms'])} in a "
              f"graph{share}; {lib_name} {c['library_ms']:.4f}ms per call, "
              f"{fmt_ms(c['library_graph_ms'])} in a graph")
    return dict(kernel="dense_message", shape=[p, v, k], dtype=dtype,
                path=path, launches=launches, max_abs_err=err, ms=ms,
                graph_ms=graph, plain_ms=plain_ms, library_ms=library_ms,
                library_graph_ms=library_graph, library=lib_name,
                bytes=nbytes, macs=macs, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=bound_ms, bound_by=bound_by, cold=cold_row,
                previous_ms=before)


def dense_k_sweep(dev, seed) -> list:
    """The thin kernel against the tiled one at the Last.fm message's phi,
    [1892, 1892] @ [1892, K] counts, K from 1 to 64: exact against each
    other and the plain version, then timed per call and in a CUDA graph.
    The widest K through which the thin kernel is the faster in the graph
    is the crossover that sets THIN_K."""
    from repro_torch.kernels.dense_message import (THIN_K, THIN_MAX_K,
                                                   dense_message)
    from repro_torch.kernels.ref import dense_message_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    phi = torch.randint(0, 100, (1892, 1892), generator=gen, device=dev,
                        dtype=torch.int32)
    rows = []
    for k in (1, 2, 4, 8, 16, 32, 64):
        m = torch.randint(0, 100, (1892, k), generator=gen, device=dev,
                          dtype=torch.int32)
        thin = dense_message(phi, m, _thin_k=THIN_MAX_K)
        check(torch.equal(thin, dense_message(phi, m, _thin_k=0))
              and torch.equal(thin, dense_message_ref(phi, m)),
              f"dense_message K sweep: thin, tiled and plain differ at K={k}")
        row = dict(k=k)
        for path, tk in (("thin", THIN_MAX_K), ("tiled", 0)):
            row[f"{path}_ms"] = cuda_ms(
                lambda: dense_message(phi, m, _thin_k=tk), 20)
            row[f"{path}_graph_ms"] = graph_ms(
                lambda: dense_message(phi, m, _thin_k=tk), 20)
        rows.append(row)
        print(f"  K={k}: thin {row['thin_ms']:.4f}ms per call, "
              f"{fmt_ms(row['thin_graph_ms'])} in a graph; tiled "
              f"{row['tiled_ms']:.4f}ms per call, "
              f"{fmt_ms(row['tiled_graph_ms'])} in a graph")
    cross = 0
    for row in rows:
        t, w = row["thin_graph_ms"], row["tiled_graph_ms"]
        if t is None or w is None:
            t, w = row["thin_ms"], row["tiled_ms"]
        if t >= w:
            break
        cross = row["k"]
    print(f"  the thin kernel is the faster through K={cross}; the wrapper's "
          f"THIN_K = {THIN_K}")
    return rows


def measure_gather_shape(runs, launches, dev, seed, level=None) -> dict:
    """expand_gather over ``level`` (a GFJS level: its A2 codes and bounds)
    or seeded runs of length 1-15 (the reference benchmark's): exact
    against the plain version, then timed beside its HBM bound, the plain
    version and ``repeat_interleave``."""
    from repro_torch.kernels.expand_gather import expand_gather
    from repro_torch.kernels.ref import expand_gather_ref
    if level is not None:
        freqs = torch.from_numpy(level.freq.astype(np.int64)).to(dev)
        payload = torch.from_numpy(
            level.key_cols["A2"].astype(np.int32)).to(dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        freqs = torch.randint(1, 16, (runs,), generator=gen, device=dev)
        payload = torch.randint(0, 1 << 20, (runs,), generator=gen,
                                device=dev, dtype=torch.int32)
    bounds = torch.cumsum(freqs, 0).to(torch.int32)
    total = int(bounds[-1])
    got, want = expand_gather(payload, bounds, total), \
        expand_gather_ref(payload, bounds, total)
    err = max_abs_err(got[None], want[None])
    check(err == 0, f"expand_gather vs plain at runs={runs}: {err}")
    del got, want
    reps = 20
    ms = cuda_ms(lambda: expand_gather(payload, bounds, total), reps)
    plain_ms = cuda_ms(lambda: expand_gather_ref(payload, bounds, total),
                       reps)
    library_ms = cuda_ms(lambda: torch.repeat_interleave(
        payload, freqs, output_size=total), reps)
    nbytes = (total + 2 * runs) * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    before = PREVIOUS_MS[("expand_gather",
                    "benchmark" if level is None else "lastfm_A1")]
    print(f"  expand_gather runs={runs} total={total} (x{launches}): kernel "
          f"{ms:.4f}ms, bound {bound_ms:.4f}ms ({bound_ms / ms:.3f} of "
          f"bound), plain {plain_ms:.4f}ms, repeat_interleave "
          f"{library_ms:.4f}ms{beside(before)}")
    return dict(kernel="expand_gather", runs=runs, total=total,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bytes=nbytes, bound_ms=bound_ms,
                bound_by="bytes", previous_ms=before)


def kernel_row(name, rows, launches, err, source, replaces) -> dict:
    """The kernels-line entry of a kernel timed at phase 6's or 7's shapes:
    sums over its path's distinct launch shapes (one launch of each;
    shapes with no launch on the path, the benchmark's, are left out)."""
    mine = [r for r in rows if r["kernel"] == name and r["launches"]]
    lib = [r["library_ms"] for r in mine]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max([err] + [r["max_abs_err"] for r in rows
                                 if r["kernel"] == name]),
        ms=sum(r["ms"] for r in mine),
        plain_ms=sum(r["plain_ms"] for r in mine),
        bound_ms=sum(r["bound_ms"] for r in mine),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in mine)
        else "operations",
        library_ms=None if None in lib else sum(lib))


# -- phase 9: the serving path ------------------------------------------------

# lastfm_A1's retained incremental state holds the elimination trace, a
# second GFJS and the expansion indices (~2 x 38.3M int64): the default
# 512 MB would drop it, and the refresh would turn into a cold rebuild
SERVICE_STATE_BYTES = 8 << 30
SERVICE_BUDGET = 1 << 30           # service (b): one lastfm_A1 entry fits
RACERS = 8


def gate(svc):
    """Hold ``svc.frame`` (an instance attribute shadowing the method)
    until released: (calls, entered, release)."""
    orig = svc.frame
    calls, entered, release = [], threading.Event(), threading.Event()

    def gated(query, plan=None):
        calls.append(query.name)
        entered.set()
        check(release.wait(600.0), "the gated build was never released")
        return orig(query, plan=plan)
    svc.frame = gated
    return calls, entered, release


def in_threads(fn, n: int) -> list:
    """``fn(i)`` for i < n on n threads at once; the results in order."""
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as exc:     # reported by the check below
            errors.append(exc)
    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    check(not errors, f"threads failed: {errors!r}")
    return out


def freed_bytes(dev, drop) -> int:
    """Device bytes that ``drop()`` hands back to the allocator."""
    gc.collect()
    sync(dev)
    held = torch.cuda.memory_allocated(dev)
    drop()
    gc.collect()
    sync(dev)
    return held - torch.cuda.memory_allocated(dev)


def levels_equal(a, b) -> bool:
    """Two summaries equal level for level: vars, codes and freq."""
    return (a.join_size == b.join_size
            and list(a.column_order) == list(b.column_order)
            and len(a.levels) == len(b.levels)
            and all(la.vars == lb.vars and np.array_equal(la.freq, lb.freq)
                    and all(np.array_equal(la.key_cols[v], lb.key_cols[v])
                            for v in la.vars)
                    for la, lb in zip(a.levels, b.levels)))


def service_answers(svc, frame_of, specs, dev, out, tracers, what):
    """Each (name, service call, frame call) through the service, split
    (host, transfers, card), held against the same frame on the CPU."""
    for name, ask, want_of in specs:
        got, t = split_call(lambda: ask(svc), dev, tracers)
        want, t_cpu = timed(lambda: want_of(frame_of), dev)
        same(got, want, f"{what} {name}")
        t["cpu_wall"] = t_cpu
        out[name] = t
        print(f"  {what} {name}: {fmt_split(t)}; device='cpu' "
              f"{t_cpu:.4f}s; equal")


def run_service_a(lastfm_kw, dev, tracer, spill, out, tracers) -> None:
    """Service (a): incremental, behind a JoinServer."""
    import repro_torch
    from repro_torch.obs.trace import Tracer
    from repro_torch.relational.synth import lastfm_like
    from repro_torch.serve import JoinServer
    from repro_torch.serve.server import lookup_rows
    from repro_torch.summary import JoinService
    from repro_torch.summary.algebra import SummaryFrame
    cat, qs = lastfm_like(**lastfm_kw)
    a1 = qs["lastfm_A1"]
    svc = JoinService(cat, device=dev, incremental=True, spill_dir=spill,
                      max_state_bytes=SERVICE_STATE_BYTES)
    server = JoinServer(svc, tracer=tracer)
    requests = out.setdefault("requests", [])

    def note(name, reply):
        t = reply.timings
        requests.append(dict(service="a", request=name, source=reply.source,
                             seconds=t["service"], server=t["server"]))
        print(f"  (a) {name}: {reply.source} in {t['service']:.4f}s "
              f"(service), {t['server']:.4f}s (server)")
        return reply

    print(f"service (a): JoinServer(JoinService(device={str(dev)!r}, "
          f"incremental=True, max_state_bytes={SERVICE_STATE_BYTES}))")
    # the racers: the leader's build waits until the others are parked
    calls, entered, release = gate(svc)

    def racer(i):
        if i:
            check(entered.wait(600.0), "no racer reached the service")
        return server.frame(a1)

    def watch():
        check(entered.wait(600.0), "no racer reached the service")
        end = time.monotonic() + 600.0
        while sum(fl.waiters for fl in
                  server._flights._flights.values()) < RACERS - 1:
            check(time.monotonic() < end, "the racers never parked")
            time.sleep(0.001)
        release.set()
    both = in_threads(lambda i: watch() if i == RACERS else racer(i),
                      RACERS + 1)
    del svc.frame
    replies = both[:RACERS]
    sources = sorted(r.source for r in replies)
    check(calls == [a1.name], f"{len(calls)} service builds for "
          f"{RACERS} racers")
    check(sources == ["collapsed"] * (RACERS - 1) + ["computed"],
          f"racer sources {sources}")
    lead = next(r for r in replies if r.source == "computed")
    note(f"lastfm_A1 cold, leader of {RACERS} racers", lead)
    waits = [r.timings["server"] for r in replies if r is not lead]
    print(f"  (a) {RACERS - 1} collapsed replies waited {min(waits):.4f}"
          f"-{max(waits):.4f}s")
    backends = {sp.args.get("backend")
                for sp in tracer.find("phase:summarize")}
    check(backends == {"numpy"}, f"traced build summarized on {backends}")
    print(f"  (a) phase:summarize backend={backends.pop()} (traced build: "
          f"numpy generation with its expansion indices); build phases s: "
          + ", ".join(f"{k} {lead.timings[k]:.4f}" for k in
                      ("build_model", "plan", "build_generator",
                       "summarize")))
    out["racers"] = dict(builds=len(calls), sources=sources,
                         leader=lead.timings["service"], waits=waits)
    again = note("lastfm_A1 again", server.frame(a1))
    check(again.source == "memory", f"warm lastfm_A1 came from "
          f"{again.source}")
    frame = again.frame
    cpu = SummaryFrame.of(frame.gfjs, "cpu")
    per_user = cpu.group_by(["U1"], count="count")
    top = per_user["U1"][int(np.argmax(per_user["count"]))]
    where = {"U1": top}
    aggs = out.setdefault("aggregates_a", {})
    service_answers(svc, cpu, [
        ("count", lambda s: s.count(a1), lambda f: f.count()),
        ("sum U2", lambda s: s.sum(a1, "U2"), lambda f: f.sum("U2")),
        ("mean U2", lambda s: s.mean(a1, "U2"), lambda f: f.mean("U2")),
        ("count by A1", lambda s: s.group_by(a1, "A1", count="count"),
         lambda f: f.group_by("A1", count="count")),
        (f"count by A2 where U1={top}",
         lambda s: s.group_by(a1, "A2", where=where, count="count"),
         lambda f: f.filter(where).group_by("A2", count="count"))],
        dev, aggs, tracers, "(a) lastfm_A1")

    users = np.arange(lastfm_kw["n_users"])
    parts = np.array_split(users, RACERS)
    rows, t_lookup = timed(lambda: in_threads(
        lambda i: server.lookup(a1, "U1", parts[i], {"n": "count"}),
        RACERS), dev)
    table = frame.group_by(["U1"], n="count")
    for keys, got in zip(parts, rows):
        check(np.array_equal(got, lookup_rows(table, "U1", ["n"], keys)),
              "lookup rows vs lookup_rows over the frame's group_by")
    st = server.stats()
    out["lookup"] = dict(keys=len(users), seconds=t_lookup,
                         probes=st["probes"], batched=st["batched"],
                         table_recomputes=st["table_recomputes"])
    print(f"  (a) lookup: COUNT per user for all {len(users)} user ids from "
          f"{RACERS} threads in {t_lookup:.4f}s ({st['probes']} vectorized "
          f"lookups, {st['batched']} batched, {st['table_recomputes']} "
          f"table build); equal to lookup_rows over the frame's group_by")

    uf = cat["user_friends"]
    n = round(uf.num_rows / 100)
    hi = lastfm_kw["n_users"] + -(-lastfm_kw["n_users"] // 100)
    rng = np.random.default_rng(lastfm_kw["seed"] + 1)
    u, f = rng.integers(0, hi, n), rng.integers(0, hi, n)
    u[0] = hi - 1                    # at least one new user: U1 grows
    f = np.where(f == u, (f + 1) % hi, f)
    u_size = frame.gfjs.domains["U1"].size
    svc.append("user_friends", {"userID": u, "friendID": f})
    r = note(f"lastfm_A1 after appending {n} user_friends rows (ids < "
             f"{hi})", server.frame(a1))
    check(r.source == "refreshed", f"lastfm_A1 after the append came from "
          f"{r.source}")
    state_bytes = [s.nbytes() for s in svc._states.values()]
    print(f"  (a) refresh {r.timings['refresh']:.4f}s ("
          + ", ".join(f"{k[8:]} {v:g}" for k, v in r.timings.items()
                      if k.startswith("refresh_")) + f"); retained state "
          f"bytes {state_bytes}; U1 domain {u_size} -> "
          f"{r.frame.gfjs.domains['U1'].size}")
    check(r.frame.gfjs.domains["U1"].size > u_size, "no domain grew")
    gj = repro_torch.GraphicalJoin(cat, a1, plan=r.plan, device=dev)
    rebuild, t_rebuild = timed(gj.run, dev)
    check(levels_equal(r.frame.gfjs, rebuild),
          "the refreshed GFJS vs a cold rebuild on the card")
    card = SummaryFrame.of(rebuild, dev)
    for name, fn in (("count", lambda x: x.count()),
                     ("sum U2", lambda x: x.sum("U2")),
                     ("count by A1", lambda x: x.group_by("A1",
                                                          count="count"))):
        same(fn(r.frame), fn(card), f"refreshed {name}")
    up = Tracer()
    with up.span("desummarize"):
        got, t_memo_free = timed(
            lambda: gj.desummarize(r.frame.gfjs, decode=False), dev)
    want = gj.desummarize(rebuild, decode=False)
    check(all(torch.equal(got[v], want[v]) for v in want),
          "desummarize of the refreshed GFJS vs the rebuild's")
    ups = up.find("engine:upload")
    out["refresh"] = dict(
        rows=n, seconds=r.timings["refresh"], service=r.timings["service"],
        report={k: v for k, v in r.timings.items()
                if k.startswith("refresh_")},
        state_bytes=state_bytes, rebuild_seconds=t_rebuild,
        desummarize_seconds=t_memo_free,
        upload_bytes=sum(s.args.get("bytes", 0) for s in ups))
    print(f"  (a) refreshed GFJS equal level for level to a cold rebuild "
          f"on the card ({t_rebuild:.4f}s), COUNT / SUM / GROUP BY equal; "
          f"its desummarize on the card {t_memo_free:.4f}s uploads "
          f"{out['refresh']['upload_bytes']} B in {len(ups)} spans, equal "
          f"to the rebuild's columns")
    del got, want
    out["stats_a"] = svc.stats()
    print(f"  (a) stats {out['stats_a']}")


def run_service_b(lastfm_kw, dev, tracer, spill, out, tracers) -> None:
    """Service (b): untraced builds on the card, a 1 GiB budget."""
    import repro_torch
    from repro_torch.relational.synth import lastfm_like
    from repro_torch.summary import JoinService
    from repro_torch.summary.algebra import SummaryFrame
    cat, qs = lastfm_like(**lastfm_kw)
    a1, a2 = qs["lastfm_A1"], qs["lastfm_A2"]
    svc = JoinService(cat, device=dev, incremental=False,
                      byte_budget=SERVICE_BUDGET, spill_dir=spill)
    requests = out.setdefault("requests", [])

    def ask(name, q, plan=None):
        with tracer.span("smoke:request", request=name):
            reply = svc.frame(q, plan=plan)
        requests.append(dict(service="b", request=name, source=reply.source,
                             seconds=reply.timings["service"]))
        print(f"  (b) {name}: {reply.source} in "
              f"{reply.timings['service']:.4f}s")
        return reply

    def answers(frame):
        return [frame.count(), frame.sum("A2"),
                frame.group_by("U1", count="count")]

    print(f"service (b): JoinService(device={str(dev)!r}, incremental=False,"
          f" byte_budget={SERVICE_BUDGET})")
    r1 = ask("lastfm_A1, cost plan", a1)
    check(r1.source == "computed" and bool(r1.frame.gfjs._launch),
          "lastfm_A1 was not built on the card")
    aux1 = r1.frame.gfjs.aux_nbytes()
    want1 = answers(r1.frame)
    swap = {"A1": "A2", "A2": "A1", "U1": "U2", "U2": "U1"}
    forced = repro_torch.GraphicalJoin(
        cat, a1, elimination_order=[swap[v] for v in r1.plan.order],
        device=dev).plan()
    check(forced.signature() != r1.plan.signature(), "one plan twice")
    r2 = ask(f"lastfm_A1, forced order {list(forced.order)}", a1, forced)
    st = svc.stats()
    check(r2.source == "computed" and st["evictions"] == 1
          and st["spills"] == 1, f"the second plan did not evict the first "
          f"to disk: {st}")
    path = Path(spill) / f"{r1.key}.gfjs"
    check(path.exists(), "no spill file for the evicted entry")
    spills = tracer.find("cache:spill")
    holder = [r1]
    del r1
    fell = freed_bytes(dev, holder.clear)
    check(fell >= aux1, f"dropping the evicted entry's last reply freed "
          f"{fell} B of its {aux1} B memo")
    out["eviction"] = dict(aux_nbytes=aux1, freed=fell,
                           spill_bytes=path.stat().st_size,
                           spill_seconds=spills[-1].seconds)
    print(f"  (b) evicted lastfm_A1 (cost plan): spill {path.stat().st_size}"
          f" B in {spills[-1].seconds:.4f}s; once no reply held it, "
          f"memory_allocated fell {fell} B (its memo: aux_nbytes {aux1})")
    r3 = ask("lastfm_A1, cost plan again", a1)
    check(r3.source == "disk", f"the evicted entry came from {r3.source}")
    check(not r3.frame.gfjs._launch, "a loaded GFJS holds a memo")
    for name, got, want in zip(("count", "sum A2", "count by U1"),
                               answers(r3.frame), want1):
        same(got, want, f"lastfm_A1 from disk: {name}")
    print("  (b) answers from the disk copy equal the first build's")
    del r2, r3

    r4 = ask("lastfm_A2", a2)
    check(r4.source == "computed" and bool(r4.frame.gfjs._launch),
          "lastfm_A2 was not built on the card")
    r5 = ask("lastfm_A2 again", a2)
    check(r5.source == "memory", f"warm lastfm_A2 came from {r5.source}")
    first = r4.frame.gfjs
    aux2 = first.aux_nbytes()
    cpu2 = SummaryFrame.of(first, "cpu")
    aggs = out.setdefault("aggregates_b", {})
    service_answers(svc, cpu2, [
        ("count", lambda s: s.count(a2), lambda f: f.count()),
        ("count by A2", lambda s: s.group_by(a2, "A2", count="count"),
         lambda f: f.group_by("A2", count="count"))],
        dev, aggs, tracers, "(b) lastfm_A2")
    del r4, r5, cpu2
    print(f"  (b) lastfm_A2 resident: resident_nbytes "
          f"{first.resident_nbytes()}, aux_nbytes {aux2}")
    before = svc.stats()
    probes = len(tracer.find("msg"))
    svc.cache.clear()
    r6 = ask("lastfm_A2 after cache.clear()", a2)
    check(r6.source == "computed", f"the rebuild came from {r6.source}")
    after = svc.stats()
    hits = {k: after[k] - before[k] for k in
            ("msgcache_hits", "msgcache_disk_hits", "msgcache_misses")}
    msg = tracer.find("msg")[probes:]
    hit_spans = sum(bool(s.args.get("hit")) for s in msg)
    check(hits["msgcache_hits"] + hits["msgcache_disk_hits"] > 0
          and hit_spans > 0, f"the rebuild reused no message: {hits}")
    check(levels_equal(r6.frame.gfjs, first),
          "the rebuild's GFJS vs the first lastfm_A2 build")
    del first
    out["msgcache"] = dict(hits, hit_spans=hit_spans, probes=len(msg),
                           rebuild=r6.timings["service"])
    print(f"  (b) rebuild: message cache {hits}, {hit_spans} of {len(msg)} "
          f"msg: spans hits; GFJS identical to the first build")
    aux2 = r6.frame.gfjs.aux_nbytes()
    holder = [r6]
    del r6
    holder.clear()
    fell = freed_bytes(dev, lambda: svc.invalidate("user_friends"))
    check(fell >= aux2, f"invalidate freed {fell} B of lastfm_A2's {aux2} "
          f"B memo")
    out["invalidate"] = dict(aux_nbytes=aux2, freed=fell)
    print(f"  (b) invalidate('user_friends'): memory_allocated fell {fell} B"
          f" (lastfm_A2's memo: aux_nbytes {aux2})")
    out["stats_b"] = svc.stats()
    out["spill_dir_bytes"] = sum(p.stat().st_size
                                 for p in Path(spill).rglob("*")
                                 if p.is_file())
    print(f"  (b) stats {out['stats_b']}; spill directory "
          f"{out['spill_dir_bytes']} B")


def run_service(lastfm_kw, dev) -> dict:
    """Phase 9: the serving path on the card, under one tracer."""
    import tempfile
    from repro_torch.obs import check as trace_check
    from repro_torch.obs.trace import Tracer
    out: dict = {}
    tracers: list = []
    tracer = Tracer()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_service_a(lastfm_kw, dev, tracer, str(Path(tmp) / "a"), out,
                      tracers)
        run_service_b(lastfm_kw, dev, tracer, str(Path(tmp) / "b"), out,
                      tracers)
    doc = tracer.to_chrome_trace()
    errs = trace_check.validate(doc, expect_server=True,
                                expect_msgcache=True)
    check(not errs, f"the service trace: {errs}")
    out["trace_spans"] = len(doc["traceEvents"])
    out["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(f"  the trace ({out['trace_spans']} events) passes "
          f"obs.check.validate(expect_server=True, expect_msgcache=True); "
          f"phase {out['seconds']:.1f}s, peak device bytes "
          f"{out.get('peak_device_bytes')}")
    return out


# -- phase 10: partitioned builds ---------------------------------------------

PARTITIONS = 4


def packed_sorted(cols: dict, sizes: dict) -> torch.Tensor:
    """The rows of ``cols`` as one multiset: each row packed into one
    int64 key (mixed radix over the domain sizes), sorted on the card."""
    check(np.prod([float(n) for n in sizes.values()]) < 2.0 ** 63,
          "rows do not pack into one int64 key")
    key = None
    for v, n in sizes.items():
        c = cols[v].to(torch.int64)
        key = c if key is None else key * n + c
    return torch.sort(key).values


def fmt_report(rep: dict) -> str:
    return (f"sizes {rep['sizes']}, seconds "
            f"[{', '.join(f'{w:.4f}' for w in rep['seconds'])}], skew "
            f"{rep['skew']:.4f}x, time skew {rep['time_skew']:.4f}x, "
            f"stragglers {[s.shard for s in rep['stragglers']]}, executor "
            f"{rep['executor']} workers={rep['workers']} "
            f"retries={rep['retries']}")


def downloads(tracer, since: int) -> tuple:
    """(bytes, summed seconds, wall seconds from the first start to the
    last end) of the ``engine:download`` spans after the first ``since``:
    summed seconds past the wall mean the shards' downloads overlapped."""
    spans = [s for s in tracer.spans[since:] if s.name == "engine:download"]
    if not spans:
        return 0, 0.0, 0.0
    return (sum(s.args.get("bytes", 0) for s in spans),
            sum(s.seconds for s in spans),
            max(s.t1 for s in spans) - min(s.t0 for s in spans))


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def run_part_a1(cat, query, mono, answers, dev, tracer, out) -> tuple:
    """(a) lastfm_A1, PARTITIONS shards on the card, thread executor."""
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.dist.partition import (PartitionScheme, hash_partition,
                                            partition_counts,
                                            partition_histogram)
    reset_peak(dev)
    gj = repro_torch.GraphicalJoin(cat, query, partitions=PARTITIONS,
                                   device=dev, tracer=tracer)
    since = len(tracer.spans)
    g, t_run = timed(gj.run, dev)
    down = downloads(tracer, since)
    plan, rep = gj.plan(), gj._executor.shard_report
    peak_run, aux = peak_bytes(dev), g.aux_nbytes()
    check(g.join_size == sum(g.shard_sizes()) == mono.join_size,
          f"lastfm_A1 shard sizes {g.shard_sizes()} vs {mono.join_size}")
    host = repro_torch.GraphicalJoin(
        cat, query, partitions=PARTITIONS,
        partition_var=plan.partition_var,
        partition_fold=plan.partition_fold, generation_backend="numpy",
        device=dev, tracer=tracer)
    gh, t_numpy = timed(host.run, dev)
    check(host.plan().backends["summarize"] == "numpy"
          and len(gh.shards) == len(g.shards), "numpy shards' plan")
    for i, (a, b) in enumerate(zip(g.shards, gh.shards)):
        check(bool(a._launch) and levels_equal(a, b),
              f"lastfm_A1 shard {i} vs numpy generation")
    del gh, host
    cols, t_des = timed(lambda: gj.desummarize(g, decode=False), dev)
    for v, c in cols.items():
        check(c.shape == (g.join_size,) and c.dtype == torch.int32
              and c.device.type == dev.type, f"lastfm_A1 sharded column {v}")
    mono_cols = engine.desummarize(mono, decode=False, device=dev)
    sizes = {v: g.domains[v].size for v in g.column_order}
    check(torch.equal(packed_sorted(cols, sizes),
                      packed_sorted(mono_cols, sizes)),
          "lastfm_A1 sharded rows vs phase 4's as a multiset")
    del cols, mono_cols
    tracers: list = []
    aggs = {}
    for name, args, kw, want in answers:
        if name == "count by U1,A2":
            continue
        got, t = split_aggregate(gj, args, kw, g, dev, tracers)
        same(got, want, f"sharded lastfm_A1 {name}")
        aggs[name] = t
        print(f"  (a) {name}: {fmt_split(t)}; equal to the monolithic "
              f"frame's")
    nshards = plan.partitions * plan.partition_fold
    pvar = plan.partition_var
    col = np.concatenate([c[pvar] for c in gj.enc.encoded_tables
                          if pvar in c])
    hist = partition_histogram(torch.from_numpy(col).to(dev), nshards,
                               device=dev)
    want = np.bincount(hash_partition(col, nshards), minlength=nshards)
    check(hist.device.type == dev.type
          and np.array_equal(hist.cpu().numpy(), want)
          and np.array_equal(want, partition_counts(
              gj.enc, PartitionScheme(pvar, nshards))),
          "partition_histogram on the card vs np.bincount(hash_partition)")
    peak = peak_bytes(dev)
    out.update(summarize=t_run, numpy_summarize=t_numpy, desummarize=t_des,
               timings={k: float(v) for k, v in gj.timings.items()},
               report={k: v for k, v in rep.items() if k != "stragglers"},
               stragglers=[s.shard for s in rep["stragglers"]],
               aux_nbytes=aux, peak_run=peak_run, peak=peak,
               histogram=hist.cpu().tolist(), aggregates=aggs,
               download_bytes=down[0], download_span_s=down[1],
               download_window_s=down[2],
               partition_var=pvar, fold=plan.partition_fold)
    print(f"  (a) lastfm_A1, {PARTITIONS} shards by hash({pvar}) "
          f"x{plan.partition_fold} fold: |Q|={g.join_size} = sum of the "
          f"shards; run {t_run:.4f}s (phases "
          f"{json.dumps(out['timings'])}); the same shards on numpy "
          f"{t_numpy:.4f}s, equal level for level")
    print(f"  (a) shard report: {fmt_report(rep)}")
    print(f"  (a) engine:download spans: {down[0]} B, {down[1]:.4f}s "
          f"summed over the shards in a {down[2]:.4f}s window")
    print(f"  (a) desummarize {t_des:.4f}s, rows equal phase 4's as a "
          f"multiset; after run(): aux_nbytes {aux} (the shards' device "
          f"memos), peak device bytes {peak_run}; in (a) {peak}")
    print(f"  (a) partition_histogram of {pvar}'s {len(col)} codes on the "
          f"card {out['histogram']}, equal to np.bincount(hash_partition)")
    return g, plan


def run_part_a2(cat, query, a2, answers, dev, tracer, out) -> None:
    """(b) lastfm_A2, PARTITIONS shards on the card."""
    import repro_torch
    from repro_torch.core.gfjs import desummarize_range
    reset_peak(dev)
    gj = repro_torch.GraphicalJoin(cat, query, partitions=PARTITIONS,
                                   device=dev, tracer=tracer)
    since = len(tracer.spans)
    g, t_run = timed(gj.run, dev)
    down = downloads(tracer, since)
    rep = gj._executor.shard_report
    peak_run, aux = peak_bytes(dev), g.aux_nbytes()
    check(g.join_size == sum(g.shard_sizes()) == a2["rows"],
          f"lastfm_A2 shard sizes {g.shard_sizes()} vs {a2['rows']}")
    tracers: list = []
    aggs = {}
    for name, args, kw, want in answers:
        if name == "sum A2":
            continue
        got, t = split_aggregate(gj, args, kw, g, dev, tracers)
        same(got, want, f"sharded lastfm_A2 {name}")
        aggs[name] = t
        print(f"  (b) {name}: {fmt_split(t)}; equal to the monolithic "
              f"frame's")
    reset_peak(dev)
    cols, t_des = timed(lambda: gj.desummarize(g, decode=False), dev)
    peak = peak_bytes(dev)
    for v, c in cols.items():
        check(c.shape == (g.join_size,) and c.device.type == dev.type,
              f"lastfm_A2 sharded column {v}")
    lo_shard, windows = 0, 0
    for i, shard in enumerate(g.shards):
        n = shard.join_size
        for lo in sorted({0, n // 2, max(n - 4096, 0)}):
            hi = min(lo + 4096, n)
            if hi <= lo:
                continue
            win = desummarize_range(shard, lo, hi, decode=False)
            for v in win:
                check(np.array_equal(
                    cols[v][lo_shard + lo:lo_shard + hi].cpu().numpy(),
                    win[v]), f"lastfm_A2 shard {i} window [{lo},{hi}) {v}")
            windows += 1
        lo_shard += n
    del cols
    out.update(summarize=t_run, desummarize=t_des,
               timings={k: float(v) for k, v in gj.timings.items()},
               report={k: v for k, v in rep.items() if k != "stragglers"},
               stragglers=[s.shard for s in rep["stragglers"]],
               aux_nbytes=aux, peak_run=peak_run, peak=peak,
               aggregates=aggs, monolithic_run=a2["t_run"],
               download_bytes=down[0], download_span_s=down[1],
               download_window_s=down[2],
               monolithic_desummarize=a2["t_expand"])
    print(f"  (b) lastfm_A2, {PARTITIONS} shards by hash("
          f"{gj.plan().partition_var}): |Q|={g.join_size} = sum of the "
          f"shards; run {t_run:.4f}s (phase 5's monolithic run "
          f"{a2['t_run']:.4f}s; phases {json.dumps(out['timings'])}), "
          f"desummarize {t_des:.4f}s (phase 5's {a2['t_expand']:.4f}s)")
    print(f"  (b) shard report: {fmt_report(rep)}")
    print(f"  (b) engine:download spans: {down[0]} B, {down[1]:.4f}s "
          f"summed over the shards in a {down[2]:.4f}s window (phase 5: "
          f"{a2['run']['download_s']:.4f}s)")
    print(f"  (b) {windows} shard windows equal numpy desummarize_range; "
          f"after run(): aux_nbytes {aux} (the shards' device memos), peak "
          f"device bytes {peak_run} (phase 5's {a2['peak_run']}); in the "
          f"desummarize {peak} (the memos, {g.join_size} x "
          f"{len(g.column_order)} int32 and one shard's level)")


def run_part_process(cat, query, dev, tracer, out) -> None:
    """(c) lastfm_A1, 2 shards built on numpy in spawned workers."""
    import repro_torch
    from repro_torch.dist.actions import shutdown_shared_executor
    gj = repro_torch.GraphicalJoin(cat, query, partitions=2,
                                   shard_executor="process",
                                   generation_backend="numpy", device=dev,
                                   tracer=tracer)
    try:
        g, t_run = timed(gj.run, dev)
    finally:
        shutdown_shared_executor()
    plan, rep = gj.plan(), gj._executor.shard_report
    check(rep["executor"] == "process" and rep["retries"] == 0,
          f"the process executor: {rep['executor']}, {rep['retries']} "
          f"retries")
    thr = repro_torch.GraphicalJoin(cat, query, partitions=2,
                                    partition_var=plan.partition_var,
                                    partition_fold=plan.partition_fold,
                                    device=dev, tracer=tracer)
    gt, t_thr = timed(thr.run, dev)
    check(len(g.shards) == len(gt.shards), "process shard count")
    for i, (a, b) in enumerate(zip(g.shards, gt.shards)):
        check(levels_equal(a, b), f"process shard {i} vs the thread "
              f"executor's")
    out.update(summarize=t_run, thread_summarize=t_thr,
               report={k: v for k, v in rep.items() if k != "stragglers"})
    print(f"  (c) lastfm_A1, 2 shards by hash({plan.partition_var}) on "
          f"numpy in spawned workers (the process executor generates on "
          f"numpy by the reference's rule): run {t_run:.4f}s (spawn "
          f"included), equal level for level to the thread executor's "
          f"card shards ({t_thr:.4f}s)")
    print(f"  (c) shard report: {fmt_report(rep)}")


def run_part_service(cat, query, a1_answers, dev, out) -> None:
    """(d) JoinService(partitions=PARTITIONS) on the card."""
    import repro_torch
    from repro_torch.core.gfjs import ShardedGFJS
    from repro_torch.relational.table import Catalog
    from repro_torch.summary import JoinService
    want = {name: got for name, _, _, got in a1_answers}
    svc = JoinService(Catalog(dict(cat.tables)), partitions=PARTITIONS,
                      device=dev)
    cold = svc.frame(query)
    check(cold.source == "computed"
          and isinstance(cold.frame.gfjs, ShardedGFJS),
          f"cold partitioned request: {cold.source}")
    warm = svc.frame(query)
    check(warm.source == "memory", f"warm request: {warm.source}")
    count, t_count = timed(lambda: svc.count(query), dev)
    same(count, want["count"], "service COUNT")
    by, t_by = timed(lambda: svc.group_by(query, "A1", count="count"), dev)
    same(by, want["count by A1"], "service GROUP BY A1")
    n = cat["user_friends"].num_rows
    users = int(cat["user_friends"]["userID"].max())
    rows = {"userID": np.asarray([0, 5, users + 2], np.int64),
            "friendID": np.asarray([users + 2, 7, 2], np.int64)}
    svc.append("user_friends", rows)
    rebuilt = svc.frame(query)
    check(rebuilt.source == "computed",
          f"after an append: {rebuilt.source}, not a rebuild")
    fresh = repro_torch.GraphicalJoin(svc.catalog, query, device=dev)
    check(rebuilt.frame.count() == fresh.join_size(),
          "the rebuilt partitioned entry's COUNT")
    aux = rebuilt.frame.gfjs.aux_nbytes()
    shard_aux = sum(s.aux_nbytes() for s in rebuilt.frame.gfjs.shards)
    del cold, warm, rebuilt, fresh
    freed = freed_bytes(dev, lambda: svc.invalidate("user_friends"))
    check(aux == shard_aux and freed >= aux,
          f"invalidate freed {freed} B of a {aux} B sharded memo")
    out.update(cold=svc.stats(), count_s=t_count, group_by_s=t_by,
               aux_nbytes=aux, freed=freed, appended_to=n)
    print(f"  (d) JoinService(partitions={PARTITIONS}): computed, memory; "
          f"COUNT {t_count:.4f}s and GROUP BY A1 {t_by:.4f}s equal (a)'s; "
          f"after a 3-row append: computed (a rebuild); invalidate freed "
          f"{freed} B >= the shards' aux_nbytes {aux} B")


def run_partitioned(cat, queries, mono_a1, a2, answers, dev) -> dict:
    """Phase 10: partitioned builds on the card, under one tracer."""
    from repro_torch.obs import check as trace_check
    from repro_torch.obs.trace import Tracer
    out: dict = {"a": {}, "b": {}, "c": {}, "d": {}}
    tracer = Tracer()
    t0 = time.perf_counter()
    g, _ = run_part_a1(cat, queries["lastfm_A1"], mono_a1,
                       answers["lastfm_A1"], dev, tracer, out["a"])
    del g
    gc.collect()
    torch.cuda.empty_cache()
    run_part_a2(cat, queries["lastfm_A2"], a2, answers["lastfm_A2"], dev,
                tracer, out["b"])
    gc.collect()
    torch.cuda.empty_cache()
    run_part_process(cat, queries["lastfm_A1"], dev, tracer, out["c"])
    with tracer.span("service"):
        run_part_service(cat, queries["lastfm_A1"], answers["lastfm_A1"],
                         dev, out["d"])
    doc = tracer.to_chrome_trace()
    errs = trace_check.validate(doc, expect_shards=True)
    check(not errs, f"the partitioned trace: {errs}")
    out["trace_spans"] = len(doc["traceEvents"])
    out["seconds"] = time.perf_counter() - t0
    print(f"  the trace ({out['trace_spans']} events) passes "
          f"obs.check.validate(expect_shards=True); phase "
          f"{out['seconds']:.1f}s")
    return out


# -- phase 11: the LM serving path ------------------------------------------

LM_ARCH = "qwen3_8b"
LM_BATCHES = ((4, 3072), (8, 256))   # (requests, prompt tokens): the online
                                     # attention path, then the dense one
LM_NEW = 32                          # new tokens per request, greedy
LM_PROFILED_STEPS = 8                # decode steps under the profiler
LM_TOKENS_PER_ROW = 16
BF16_FLOP_PER_S = 989e12             # H100 SXM data sheet, dense tensor cores
# float32 logits: (a) decode against the teacher-forced forward at full
# width (other reduction orders over d = 4096), (b) the card against the
# CPU at smoke width; the KV layouts against each other
LM_WIDTH_TOL = 1e-3
LM_CARD_TOL = 1e-4
LM_LAYOUT_TOL = 1e-5


def lm_configs() -> dict:
    """Phase 11's configurations: (a) the architecture at full width, two
    layers, float32; (b) the smoke variants of qwen3_8b and gemma3_4b in
    float32; (c) the full architecture (bf16, every layer)."""
    from repro_torch.configs import get_config, get_smoke
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    full = get_config(LM_ARCH)
    return dict(width=full.scaled(num_layers=2, **f32),
                smoke=[get_smoke(a).scaled(**f32)
                       for a in ("qwen3_8b", "gemma3_4b")],
                full=full)


def seeded_tokens(vocab: int, shape, seed: int, dev) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape)).to(dev)


def media_kw(cfg, B: int, seed: int, dev) -> dict:
    """The model's inputs beside its tokens: the vlm family's image
    context, float32 [B, num_image_tokens, vision_dim] from
    ``default_rng(seed)`` (the reference's stub patch embeddings), as
    ``vision=``; nothing for the other families."""
    if cfg.family != "vlm":
        return {}
    v = cfg.vlm
    return {"vision": torch.from_numpy(np.random.default_rng(seed).normal(
        size=(B, v.num_image_tokens, v.vision_dim)).astype(
            np.float32)).to(dev)}


def seeded_frames(B: int, S: int, seed: int, dev) -> torch.Tensor:
    """The audio family's input: float32 [B, S, 512] frame embeddings
    from ``default_rng(seed)`` (the reference's stub frontend)."""
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(B, S, 512)).astype(np.float32)).to(dev)


def set_kv_layout(lm, layout: str) -> None:
    from repro_torch.models.attention import GQAttention
    for m in lm.modules():
        if isinstance(m, GQAttention):
            m.kv_layout = layout


def stepwise_logits(lm, toks, k: int, **kw) -> torch.Tensor:
    """prefill toks[:, :k], then decode the rest one token at a time:
    the logits at positions k-1 .. S-2, [B, S-k, V].  ``kw`` (the vlm's
    ``vision``) goes to the prefill and to every step."""
    S = toks.shape[1]
    logits, caches = lm.prefill(toks[:, :k], S, **kw)
    out = [logits[:, 0]]
    for t in range(k, S - 1):
        logits, caches = lm.decode_step(toks[:, t:t + 1], caches, **kw)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def lm_width_consistency(cfg, dev, *, logit_scaled: bool = False) -> dict:
    """(a) prefill + stepwise decode equal the teacher-forced forward, at
    full width on the card, in both KV layouts, which agree to
    LM_LAYOUT_TOL; with ``logit_scaled`` (phase 12) to LM_LAYOUT_TOL
    times max|logits|, since a random tied head (granite-moe) gives
    logits of std sqrt(d_model), ~30x an untied one's."""
    from repro_torch.models.model import LM
    lm = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(1))
    toks = seeded_tokens(cfg.vocab, (2, 16), 11, dev)
    kw = media_kw(cfg, 2, 12, dev)
    out: dict = {}
    runs = {}
    with torch.inference_mode():
        for layout in ("grouped", "repeat"):
            set_kv_layout(lm, layout)
            full = lm(toks, **kw)
            steps = stepwise_logits(lm, toks, 8, **kw)
            want = full[:, 7:15]
            err = float((steps - want).abs().max())
            ok = torch.allclose(steps, want, atol=LM_WIDTH_TOL,
                                rtol=LM_WIDTH_TOL)
            check(ok, f"(a) {layout}: decode logits against the forward "
                  f"differ by {err}")
            out[f"decode_err_{layout}"] = err
            runs[layout] = (full, steps)
    out["layout_err"] = max(float((a - b).abs().max()) for a, b in
                            zip(runs["grouped"], runs["repeat"]))
    out["logit_max"] = float(runs["grouped"][0][..., :cfg.vocab].abs().max())
    if logit_scaled:
        layout_tol = LM_LAYOUT_TOL * out["logit_max"]
        agree = out["layout_err"] <= layout_tol
    else:
        layout_tol = LM_LAYOUT_TOL
        agree = all(torch.allclose(a, b, atol=LM_LAYOUT_TOL,
                                   rtol=LM_LAYOUT_TOL)
                    for a, b in zip(runs["grouped"], runs["repeat"]))
    check(agree, f"(a) the KV layouts differ by {out['layout_err']}")
    out["param_bytes"] = lm.param_bytes()
    print(f"  (a) {cfg.name} at full width, {cfg.num_layers} layers, "
          f"float32 ({out['param_bytes']} B): prefill + 7 decode steps "
          + ("(seeded image context [2, "
             f"{cfg.vlm.num_image_tokens}, {cfg.vlm.vision_dim}] at each) "
             if kw else "") +
          f"against the forward, max |diff| grouped "
          f"{out['decode_err_grouped']:.3g} / repeat "
          f"{out['decode_err_repeat']:.3g} (tol {LM_WIDTH_TOL}, |logits| <= "
          f"{out['logit_max']:.3g}); layouts agree to {out['layout_err']:.3g}"
          f" (tol {layout_tol:.3g})")
    return out


def lm_card_against_cpu(cfgs, dev) -> dict:
    """(b) the smoke models on the card against the same weights on the
    CPU: logits to LM_CARD_TOL, 8 greedy tokens equal."""
    from repro_torch.models.model import LM
    from repro_torch.serve import ServeConfig, ServeEngine
    out: dict = {}
    for i, cfg in enumerate(cfgs):
        cpu = LM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(20 + i))
        card = LM(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        toks = seeded_tokens(cfg.vocab, (3, 16), 21 + i, "cpu")
        kw = media_kw(cfg, 3, 121 + i, "cpu")
        card_kw = {k: v.to(dev) for k, v in kw.items()}
        with torch.inference_mode():
            want = cpu(toks, **kw)
            got = card(toks.to(dev), **card_kw).cpu()
            want_s = stepwise_logits(cpu, toks, 8, **kw)
            got_s = stepwise_logits(card, toks.to(dev), 8, **card_kw).cpu()
        err = max(float((got - want).abs().max()),
                  float((got_s - want_s).abs().max()))
        check(torch.allclose(got, want, atol=LM_CARD_TOL, rtol=LM_CARD_TOL)
              and torch.allclose(got_s, want_s, atol=LM_CARD_TOL,
                                 rtol=LM_CARD_TOL),
              f"(b) {cfg.name}: the card's logits differ from the CPU's by "
              f"{err}")
        scfg = ServeConfig(max_seq=24)
        a = ServeEngine(cpu, scfg, device="cpu").generate(
            {"tokens": toks, **kw}, 8)
        b = ServeEngine(card, scfg, device=dev).generate(
            {"tokens": toks, **kw}, 8)
        check(np.array_equal(a, b), f"(b) {cfg.name}: greedy tokens differ "
              f"between the card and the CPU")
        out[cfg.name] = dict(max_err=err, tokens=b.tolist())
        print(f"  (b) {cfg.name} float32: logits (forward, prefill, decode) "
              f"on the card against the CPU, max |diff| {err:.3g} (tol "
              f"{LM_CARD_TOL}); 8 greedy tokens equal: {b[0].tolist()}")
    return out


def timed_greedy(lm, tokens, s_max: int, new: int, dev, **kw):
    """Greedy prefill + decode with the host clock around each part:
    (tokens [B, new], prefill s, decode s per step, the caches and the
    last token, to go on decoding from).  ``kw``: the vlm's ``vision``,
    to the prefill and every step."""
    with torch.inference_mode():
        sync(dev)
        t0 = time.perf_counter()
        logits, caches = lm.prefill(tokens, s_max, **kw)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        sync(dev)
        t1 = time.perf_counter()
        out = [tok]
        for _ in range(new - 1):
            logits, caches = lm.decode_step(tok, caches, **kw)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
        sync(dev)
        t2 = time.perf_counter()
    return (torch.cat(out, 1).to(torch.int32).cpu().numpy(), t1 - t0,
            (t2 - t1) / (new - 1), caches, tok)


def kernel_seconds_by_name(events, top: int = 8) -> dict:
    """The card's kernel seconds and launches in a profiled call's trace
    events, by kernel name (its first 60 characters), the largest
    ``top``."""
    by: dict = {}
    for e in events or ():
        if e.get("cat") == "kernel":
            s, n = by.get(e["name"][:60], (0.0, 0))
            by[e["name"][:60]] = (s + e.get("dur", 0) / 1e6, n + 1)
    return dict(sorted(by.items(), key=lambda kv: -kv[1][0])[:top])


def cache_inventory(lm) -> tuple:
    """(GQA KV caches, MLA latent caches, recurrent state bytes per batch
    row) of ``lm``'s decode caches, read off caches built for one row and
    one position: zamba2 has one KV cache per unit (its shared block's)
    beside its Mamba2 states, xLSTM none."""
    from repro_torch.models.attention import KVCache
    counts = [0, 0, 0]

    def walk(c):
        if isinstance(c, (list, tuple)):
            for x in c:
                walk(x)
        elif isinstance(c, KVCache):
            counts[c.v is None] += 1
        else:
            counts[2] += sum(t.numel() * t.element_size() for t in
                             (getattr(c, f.name)
                              for f in dataclasses.fields(c)))

    walk(lm.init_caches(1, 1))
    return tuple(counts)


def recurrent_ops(lm, B: int, S: int) -> tuple:
    """(operations at the bf16 peak, at the float32 peak) of the recurrent
    blocks' products beyond their weights, for ``[B, S]`` tokens (``S =
    1``: a decode step).  Mamba2's chunked SSD in the compute dtype: the
    causal ``C B^T`` and its product with the inputs within each chunk of
    ``Q``, the chunk states and their readout (``4 N H P`` a token); its
    decode the state update and readout.  The mLSTM's in float32: the
    causal ``q k^T`` and its product with ``v`` within each chunk, the
    products with ``C`` (``4 dk dv`` a head a token); its decode the same
    ``4 dk dv``.  The sLSTM's recurrent product is a weight (``r``) used
    once a token, counted with the weights."""
    from repro_torch.models.ssm import Mamba2Block
    from repro_torch.models.xlstm import MLSTMBlock
    bf = f32 = 0
    for m in lm.modules():
        if isinstance(m, Mamba2Block):
            H, P, N, Q = m.heads, m.P, m.N, min(m.cfg.ssm.chunk, S)
            bf += B * (4 * H * N * P if S == 1 else
                       S * (Q + 1) * (N + H * P) + 4 * S * N * H * P)
        elif isinstance(m, MLSTMBlock):
            H, dk, dv, Q = m.heads, m.dk, m.dv, min(256, S)
            f32 += B * H * (4 * dk * dv if S == 1 else
                            S * (Q + 1) * (dk + dv) + 4 * S * dk * dv)
    return bf, f32


def lm_bounds(lm, B: int, S: int, new: int) -> dict:
    """The least time the card could take for this run's prefill and its
    decode steps, or for an encoder (HuBERT) its encode: ``forward`` over
    ``[B, S]`` frames (``encode_s``; no cache, no decode).  Bytes: each
    weight read once at its own width (the embedding table: only the rows
    looked up, unless the head reads it whole; every expert of a MoE
    layer, since the products batched over E read them all; the router is
    float32; zamba2's shared block once, though it runs in every unit),
    the KV caches written once (prefill) or read up to the current
    position (decode): K and V of each attention application (zamba2: one
    a unit; the vlm's cross layers have none), or MLA's latent of
    ``kv_lora + rope`` per position; the recurrent states (Mamba2's
    ``[H, N, P]`` and conv window, the mLSTM's ``C``, ``n``, ``m``, the
    sLSTM's four ``[d]``; ``cache_inventory``) written once (prefill) or
    read and written once (a decode step); the vlm's float32 image context
    ``[B, T, vision_dim]`` read once a call (decode steps included), the
    encoder's float32 frames ``[B, S, 512]`` read once; and the logits
    written once (an encode's at every position).  Operations: 2 per
    matrix weight per token (zamba2's shared block once a unit; the
    audio family's ``frontend_proj`` per frame), except a cross layer's
    ``wk`` and ``wv``, 2 per weight per image token at every call (``T``
    of them a request, recomputed at each decode step, as the reference
    does); at the float32 peak for float32 weights (the xLSTM gates and
    the sLSTM's ``wx`` and ``r``) and at the bf16 peak for the rest; the
    experts' ``2*3*d*d_ff_expert`` per capacity slot computed (``E *
    cap`` a MoE layer a call); the attention's two products over the
    positions each query sees: causal ``2*H*hd*S*(S+1)*B`` a layer, non-
    causal (the encoder) ``4*H*hd*S*S*B``, a cross layer ``4*H*hd*Sq*T*B``
    (MLA's prefill ``nope + rope`` for scores and ``v`` for values per
    head; its absorbed decode ``H*(2*(kv_lora + rope) + 2*kv_lora)`` per
    cached position); the recurrent blocks' products
    (``recurrent_ops``); the head only for the last position (as
    ``prefill`` computes it), for every position of an encode; and the
    router's ``2*d*E`` per token at the float32 peak.  Elementwise work
    (norms, gates, decays, softmax) is not counted."""
    from repro_torch.models.attention import GQAttention
    from repro_torch.models.model import FRAME_DIM, VLMUnit
    from repro_torch.models.moe import MoEBlock, capacity
    cfg = lm.cfg
    elt = 2 if cfg.param_dtype == "bfloat16" else 4
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim_)
    Vp = lm.vocab_padded
    named = dict(lm.named_parameters())
    embed = named.get("embed")          # the audio family has none
    experts = [m for m in lm.modules() if isinstance(m, MoEBlock)]
    cross = [u.x.attn for u in lm.modules() if isinstance(u, VLMUnit)]
    T = cfg.vlm.num_image_tokens if cross else 0
    cross_kv = {id(p) for a in cross for p in (a.wk, a.wv)}
    xkv = sum(p.numel() for a in cross for p in (a.wk, a.wv))
    image_bytes = B * T * (cfg.vlm.vision_dim if cross else 0) * 4
    expert_w = {id(getattr(m, w)) for m in experts
                for w in ("router", "w_gate", "w_up", "w_down")}
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in named.values() if p is not embed)
    if cfg.tie_embeddings and embed is not None:
        weight_bytes += embed.numel() * embed.element_size()
    applied = [(p, 1) for n, p in named.items()
               if n.startswith("segments.") or n == "frontend_proj"]
    if lm.shared is not None:
        applied += [(p, len(lm.segments["units"]))
                    for p in lm.shared.parameters()]
    mats = {f32: sum(p.numel() * k for p, k in applied
                     if p.dim() >= 2 and id(p) not in expert_w
                     and id(p) not in cross_kv
                     and (p.dtype == torch.float32) == f32)
            for f32 in (False, True)}
    head = d * Vp
    all_bytes = sum(p.numel() * p.element_size() for p in named.values())
    all_params = sum(p.numel() for p in named.values())

    def cross_ops(sq: int) -> int:
        """The cross layers' image K/V and their two products, for ``sq``
        text positions a request."""
        return (2 * xkv * T + 4 * H * hd * sq * T * len(cross)) * B

    if lm.encoder_only:
        layers = sum(isinstance(m, GQAttention) for m in lm.modules())
        enc_bytes = weight_bytes + B * S * FRAME_DIM * 4 + B * S * Vp * 4
        enc_ops = 2 * (mats[False] + head) * B * S \
            + 4 * H * hd * S * S * B * layers
        ops_s = enc_ops / BF16_FLOP_PER_S \
            + 2 * mats[True] * B * S / FP32_FLOP_PER_S
        return dict(encode_s=max(enc_bytes / HBM_BYTES_PER_S, ops_s),
                    encode_bound_by="operations"
                    if ops_s > enc_bytes / HBM_BYTES_PER_S else "bytes",
                    encode_ops=enc_ops, encode_bytes=enc_bytes,
                    coarse_encode_s=2 * all_params * B * S
                    / BF16_FLOP_PER_S)
    n_gqa, n_mla, state_row = cache_inventory(lm)
    if n_mla:
        m = cfg.mla
        lat, dqk, r = (m.kv_lora_rank + m.rope_head_dim,
                       m.nope_head_dim + m.rope_head_dim, m.kv_lora_rank)

    def cache_elems(pos: int) -> int:
        out = 2 * n_gqa * B * KV * pos * hd
        return out + (n_mla * B * pos * lat if n_mla else 0)

    def expert_ops(n_tok: int) -> tuple:
        """(bf16 operations of the capacity slots, f32 of the routers)."""
        bf = f32 = 0
        for mod in experts:
            me = mod.cfg.moe
            cap = capacity(n_tok, me.experts_per_token, me.num_experts,
                           me.capacity_factor)
            bf += 6 * d * me.d_ff_expert * me.num_experts * cap
            f32 += 2 * d * me.num_experts * n_tok
        return bf, f32

    pairs = S * (S + 1) // 2 if cfg.causal else S * S
    pre_bytes = weight_bytes + (B * S * d + cache_elems(S)) * elt \
        + B * Vp * 4 + B * state_row + image_bytes
    moe_bf, moe_f32 = expert_ops(B * S)
    rec_bf, rec_f32 = recurrent_ops(lm, B, S)
    pre_ops = 2 * mats[False] * B * S \
        + 4 * H * hd * pairs * B * n_gqa + 2 * head * B + moe_bf \
        + rec_bf + cross_ops(S)
    pre_f32 = moe_f32 + 2 * mats[True] * B * S + rec_f32
    if n_mla:
        pre_ops += H * (dqk + m.v_head_dim) * S * (S + 1) * B * n_mla
    pre_ops_s = pre_ops / BF16_FLOP_PER_S + pre_f32 / FP32_FLOP_PER_S
    pre = max(pre_bytes / HBM_BYTES_PER_S, pre_ops_s)
    step_bf, step_f32 = expert_ops(B)
    rec_bf, rec_f32 = recurrent_ops(lm, B, 1)
    step_f32 += 2 * mats[True] * B + rec_f32
    steps, by_bytes = [], 0
    for pos in range(S, S + new - 1):        # the cache holds pos + 1
        b = weight_bytes + (B * d + cache_elems(pos + 1)) * elt \
            + B * Vp * 4 + 2 * B * state_row + image_bytes
        ops = 2 * (mats[False] + head) * B \
            + 4 * H * hd * (pos + 1) * B * n_gqa + step_bf + rec_bf \
            + cross_ops(1)
        if n_mla:
            ops += H * (2 * lat + 2 * r) * (pos + 1) * B * n_mla
        ops_s = ops / BF16_FLOP_PER_S + step_f32 / FP32_FLOP_PER_S
        steps.append(max(b / HBM_BYTES_PER_S, ops_s))
        by_bytes += b / HBM_BYTES_PER_S > ops_s
    return dict(prefill_s=pre, prefill_bound_by="operations"
                if pre_ops_s > pre_bytes / HBM_BYTES_PER_S else "bytes",
                prefill_ops=pre_ops, prefill_f32_ops=pre_f32,
                decode_step_s=sum(steps) / len(steps), decode_bound_by=
                "bytes" if 2 * by_bytes > len(steps) else "operations",
                state_bytes=B * state_row, kv_caches=n_gqa + n_mla,
                cross_layers=len(cross),
                coarse_decode_step_s=all_bytes / HBM_BYTES_PER_S,
                coarse_prefill_s=2 * all_params * B * S / BF16_FLOP_PER_S)


def lm_serving(cat, query, cfg, dev, prov=None) -> dict:
    """(c) the full model serving join-fed prompts with join features
    (from ``prov``, or a provider over a new card ``JoinService``).
    A model whose prefill loops over time (an sLSTM: xLSTM) runs lighter
    repeats, printed: one greedy run through the engine beside the timed
    one (not two), no sampled runs, and the busy share's decode steps go
    on from the timed run's caches instead of a new prefill.  A vlm
    request carries seeded image context (``media_kw``), to the prefill
    and every decode step."""
    from repro_torch.core.gfjs import desummarize_range
    from repro_torch.data import JoinCorpus, TokenBatcher
    from repro_torch.models.model import LM
    from repro_torch.models.xlstm import SLSTMBlock
    from repro_torch.serve import (RelationalFeatureProvider, ServeConfig,
                                   ServeEngine, lookup_rows)
    from repro_torch.summary import JoinService
    from repro_torch.summary.algebra import SummaryFrame
    out: dict = {}
    corpus, t_corpus = timed(lambda: JoinCorpus.build(
        cat, query, vocab=cfg.vocab, tokens_per_row=LM_TOKENS_PER_ROW,
        device=dev), dev)
    if prov is None:
        prov = RelationalFeatureProvider(JoinService(cat, device=dev), query,
                                         key_var="U1",
                                         aggs={"n_paths": "count"})
    svc = prov.service
    print(f"  (c) JoinCorpus over {query.name} on the card: "
          f"{corpus.num_rows} rows in {t_corpus:.4f}s, "
          f"{LM_TOKENS_PER_ROW} tokens per row, vocab {cfg.vocab}")

    reset_peak(dev)
    lm, t_build = timed(lambda: LM(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(0)), dev)
    out["param_bytes"] = lm.param_bytes()
    out["params"] = sum(p.numel() for p in lm.parameters())
    print(f"  (c) {cfg.name}: {cfg.num_layers} layers, {out['params']} "
          f"parameters, {out['param_bytes']} B in {cfg.param_dtype}, built "
          f"and drawn on the card in {t_build:.3f}s")
    light = any(isinstance(m, SLSTMBlock) for m in lm.modules())
    if light:
        print(f"  (c) {cfg.name}: its prefill loops over time (sLSTM), so "
              f"cut to one greedy run beside the timed one, no sampled "
              f"runs, the busy share's steps on the timed run's caches")
    cursor = 0
    table = None            # GROUP BY U1 on device="cpu", the oracle
    for B, S in LM_BATCHES:
        row = {"requests": B, "prompt": S, "new": LM_NEW}
        batcher = TokenBatcher(corpus, B, S, cursor=cursor, device=dev)
        batch = batcher.next_batch()
        check(batch["tokens"].is_cuda == (dev.type == "cuda")
              and batch["tokens"].dtype == torch.int32
              and tuple(batch["tokens"].shape) == (B, S),
              "TokenBatcher's tokens: int32 [B, S] on the device")
        # each request's user: U1 of the first join row its prompt came from
        rows = [cursor + i * (S + 1) // LM_TOKENS_PER_ROW for i in range(B)]
        keys = np.concatenate([desummarize_range(
            corpus.gfjs, r, r + 1, decode=True)["U1"] for r in rows])
        cursor = batcher.cursor
        engine = ServeEngine(lm, ServeConfig(max_seq=S + LM_NEW),
                             feature_provider=prov, device=dev)
        batch, t_feat = timed(lambda: engine.attach_features(batch, keys),
                              dev)
        kw = media_kw(cfg, B, 200 + B, dev)
        batch.update(kw)
        feats = batch["features"].cpu().numpy()
        if table is None:
            table = SummaryFrame.of(svc.frame(query).frame.gfjs,
                                    device="cpu").group_by(
                ["U1"], n_paths="count")
        want = lookup_rows(table, "U1", ["n_paths"], keys)
        check(np.array_equal(feats, want), "(c) the provider's features "
              "differ from group_by on device='cpu'")
        check((feats > 0).all(), "(c) a prompt's user has no join rows")
        row.update(features=feats[:, 0].tolist(), feature_s=t_feat,
                   users=keys.tolist())
        # the greedy runs warm the card up for the timed one
        greedy = [engine.generate(batch, LM_NEW, seed=s)
                  for s in ((1,) if light else (1, 2))]
        room = 2 * LM_PROFILED_STEPS + 1 if light else 0
        got, pre_s, step_s, run_caches, run_tok = timed_greedy(
            lm, batch["tokens"], S + LM_NEW + room, LM_NEW, dev, **kw)
        check(all(np.array_equal(got, g) for g in greedy),
              f"(c) {B} x {S}: greedy runs disagree")
        check(greedy[0].shape == (B, LM_NEW) and (greedy[0] >= 0).all()
              and (greedy[0] < cfg.vocab).all(),
              f"(c) {B} x {S}: tokens outside [0, vocab)")
        row["greedy_runs"] = len(greedy) + 1
        row["sampled_differ"] = None
        if not light:
            hot = ServeEngine(lm, ServeConfig(max_seq=S + LM_NEW,
                                              temperature=1.0), device=dev)
            sampled = [hot.generate(batch, LM_NEW, seed=s) for s in (1, 2)]
            row["sampled_differ"] = not np.array_equal(sampled[0],
                                                       sampled[1])
            # a random tied head (embedding std 1) gives logits of std
            # sqrt(d_model): temperature 1 then draws the argmax,
            # whatever the seed
            check(row["sampled_differ"] or cfg.tie_embeddings,
                  f"(c) {B} x {S}: sampled runs with seeds 1 and 2 agree")
        bound = lm_bounds(lm, B, S, LM_NEW)
        row.update(prefill_s=pre_s, decode_step_s=step_s,
                   prefill_tokens_per_s=B * S / pre_s,
                   decode_tokens_per_s=B / step_s, bound=bound,
                   greedy=greedy[0][:, :8].tolist())

        # the card's busy share of a decode loop
        with torch.inference_mode():
            if light:
                caches, first = run_caches, run_tok
            else:
                # room for two loops: timed, then profiled
                logits, caches = lm.prefill(batch["tokens"],
                                            S + 2 * LM_PROFILED_STEPS + 1,
                                            **kw)
                first = logits[:, -1].argmax(-1, keepdim=True)

            def loop():
                tok = first
                for _ in range(LM_PROFILED_STEPS):
                    lg, _ = lm.decode_step(tok, caches, **kw)
                    tok = lg[:, -1].argmax(-1, keepdim=True)
            _, wall = timed(loop, dev)
            events = profiled_events(loop, dev)
            row["busy"] = busy_of(event_seconds(events), wall)
            row["decode_kernels"] = kernel_seconds_by_name(events)
        print(f"  (c) {B} x {S} prompts (+{LM_NEW} tokens): features "
              f"{row['features']} for users {row['users']} in {t_feat:.4f}s,"
              f" equal to group_by on the CPU; prefill {pre_s:.4f}s, "
              f"{B * S / pre_s:.1f} tokens/s, "
              f"bound {bound['prefill_s']:.4f}s by "
              f"{bound['prefill_bound_by']} (2 x all parameters x tokens / "
              f"bf16 peak: {bound['coarse_prefill_s']:.4f}s); decode "
              f"{step_s * 1e3:.3f} ms/step, {B / step_s:.1f} tokens/s, bound "
              f"{bound['decode_step_s'] * 1e3:.3f} ms by "
              f"{bound['decode_bound_by']} (all parameter bytes / HBM: "
              f"{bound['coarse_decode_step_s'] * 1e3:.3f} ms); decode loop "
              f"{fmt_busy(row['busy'])}; greedy "
              f"{row['greedy_runs']} runs equal, sampled seeds 1 / 2 "
              + ("not run" if light else "differ" if row["sampled_differ"]
                 else "agree"))
        print(f"      the decode loop's card time by kernel ("
              f"{LM_PROFILED_STEPS} steps, s): "
              + ", ".join(f"{k} {v[0]:.6f} x{v[1]}" for k, v in
                          row["decode_kernels"].items()))
        out[f"{B}x{S}"] = row
        del batch, caches, run_caches, kw
    out["peak_device_bytes"] = peak_bytes(dev)
    print(f"  (c) peak device bytes {out['peak_device_bytes']} (parameters "
          f"{out['param_bytes']})")
    del lm
    return out


def run_lm_serving(cat, queries, dev) -> dict:
    """Phase 11: the LM serving path on the card."""
    cfgs = lm_configs()
    t0 = time.perf_counter()
    out = dict(width=lm_width_consistency(cfgs["width"], dev))
    gc.collect()
    torch.cuda.empty_cache()
    out["smoke"] = lm_card_against_cpu(cfgs["smoke"], dev)
    out["full"] = lm_serving(cat, queries["lastfm_A1"], cfgs["full"], dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.1f}s")
    return out


# -- phase 12: the moe family's serving path ---------------------------------

MOE_ARCHS = ("granite_moe_1b_a400m", "deepseek_v2_236b")
# deepseek-v2's 60 layers take 472 GB in bf16; one card holds 4 (one
# dense, three MoE: 26.6 GB)
MOE_LAYERS = {"deepseek_v2_236b": 4}
MOE_DROP_FREE = 64.0     # (a)'s capacity factor, as tests/test_models.py


def moe_configs() -> dict:
    """Phase 12's configurations per architecture: (a) full width, two
    layers, float32, drop-free; (b) the smoke variant in float32 at the
    config's capacity; (c) the full widths in bf16, deepseek's depth cut
    to MOE_LAYERS."""
    from repro_torch.configs import get_config, get_smoke
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    out = {}
    for arch in MOE_ARCHS:
        full = get_config(arch)
        out[arch] = dict(
            width=full.scaled(num_layers=2, moe=dataclasses.replace(
                full.moe, capacity_factor=MOE_DROP_FREE), **f32),
            smoke=get_smoke(arch).scaled(**f32),
            full=full.scaled(num_layers=MOE_LAYERS.get(arch,
                                                       full.num_layers)))
    return out


def dropped_slots(lm, fn) -> tuple:
    """(slots dropped by capacity, slots routed) in ``lm``'s MoE layers
    while ``fn()`` runs, from each layer's own ``route`` and
    ``dispatch`` on its inputs."""
    from repro_torch.models.moe import MoEBlock, capacity
    counts = [0, 0]

    def count(mod, args):
        x = args[0]
        me, n_tok = mod.cfg.moe, x.shape[0] * x.shape[1]
        top_e, _ = mod.route(x.reshape(n_tok, -1))
        _, keep = mod.dispatch(top_e, capacity(
            n_tok, me.experts_per_token, me.num_experts,
            me.capacity_factor))
        counts[0] += int((~keep).sum())
        counts[1] += keep.numel()

    hooks = [m.register_forward_pre_hook(count) for m in lm.modules()
             if isinstance(m, MoEBlock)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return tuple(counts)


def card_runs_equal(cfg, dev, seed: int):
    """(b) two runs (forward, prefill, 7 decode steps) of a card model
    bit-equal: (the model, its tokens, True)."""
    from repro_torch.models.model import LM
    lm = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(
        seed))
    toks = seeded_tokens(cfg.vocab, (3, 16), seed, dev)
    kw = media_kw(cfg, 3, 100 + seed, dev)
    with torch.inference_mode():
        runs = [(lm(toks, **kw), stepwise_logits(lm, toks, 8, **kw))
                for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    check(same, f"(b) {cfg.name}: two card runs differ")
    return lm, toks, same


def moe_card_runs(cfg, dev, seed: int) -> dict:
    """(b)'s second half: on a card model, the slots its stepwise run
    drops, and two runs (forward, prefill, decode steps) bit-equal."""
    lm, toks, same = card_runs_equal(cfg, dev, seed)
    with torch.inference_mode():
        dropped, routed = dropped_slots(
            lm, lambda: stepwise_logits(lm, toks, 8))
    print(f"  (b) {cfg.name}: two card runs (forward, prefill, 7 decode "
          f"steps) bit-equal; the stepwise run drops {dropped} of "
          f"{routed} routed slots at capacity factor "
          f"{cfg.moe.capacity_factor}")
    return dict(bit_equal=same, dropped=dropped, routed=routed)


def run_moe_serving(cat, queries, dev) -> dict:
    """Phase 12: the moe family's serving path on the card."""
    cfgs = moe_configs()
    t0 = time.perf_counter()
    out: dict = {}
    for i, arch in enumerate(MOE_ARCHS):
        c = cfgs[arch]
        row = dict(width=lm_width_consistency(c["width"], dev,
                                              logit_scaled=True))
        gc.collect()
        torch.cuda.empty_cache()
        row["smoke"] = lm_card_against_cpu([c["smoke"]], dev)
        row["smoke"].update(moe_card_runs(c["smoke"], dev, 30 + i))
        row["full"] = lm_serving(cat, queries["lastfm_A1"], c["full"], dev)
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = row
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.1f}s")
    return out


# -- phase 13: training on the card ------------------------------------------

TRAIN_TOL = 1e-5           # (a) card against CPU: |card - cpu| / |cpu| (L2)
                           # per tensor, float32
TRAIN_PARITY_STEPS = 2     # (a) AdamW steps compared with the CPU
TRAIN_BIT_STEPS = 3        # (a) steps of the two bit-equal card runs
TRAIN_RESUME = dict(steps=8, checkpoint_every=4, crash_after_step=6)
TRAIN_FULL = dict(granite_moe_1b_a400m=(20, 8, 1024),  # steps, B, S
                  qwen3_8b=(5, 2, 4096))
TRAIN_LAYERS = {"qwen3_8b": 12}     # of 36: the state of all 36 would be
                                    # ~98 GB; 12 hold ~43 GB of it
TRAIN_FREE = 10 << 30      # (d) device bytes that must stay free
# (c) / (d): warm up over 2 steps to 1e-3, so that 20 steps move a random
# model's loss by more than the spread between batches (at 3e-4, 20 steps
# of a narrowed granite on the CPU moved it by less)
TRAIN_LR = 1e-3
# steps under the profiler: granite's 5 launch over 60,000 kernels, one
# Qwen3-8B step (its online attention) ~28,000, and the profiler takes
# several times the steps' own time to record and hand them over
TRAIN_PROFILED_STEPS = {"granite_moe_1b_a400m": 5, "qwen3_8b": 2}
TRAIN_TIMED_STEPS = 10     # (c) ms per step: median of the last ten
CKPT_DIR = ROOT / "build" / "phase13_ckpt"
CUBLAS_DETERMINISTIC = ":4096:8"


def train_configs() -> dict:
    """Phase 13's configurations: (a) the qwen3_8b and granite smoke
    configs in float32 (granite drop-free for the gradients, at its
    capacity for the bit-equal runs); (b) the qwen3_8b smoke config as
    the configs have it (bf16); (c) granite-moe at full size; (d)
    Qwen3-8B at full width, its depth cut to TRAIN_LAYERS."""
    from repro_torch.configs import get_config, get_smoke
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    qwen = get_smoke("qwen3_8b").scaled(**f32)
    granite = get_smoke("granite_moe_1b_a400m").scaled(**f32)
    full = {a: get_config(a) for a in TRAIN_FULL}
    return dict(
        parity=[qwen, granite.scaled(moe=dataclasses.replace(
            granite.moe, capacity_factor=MOE_DROP_FREE))],
        bits=[qwen, granite], resume=get_smoke("qwen3_8b"),
        full={a: c.scaled(num_layers=TRAIN_LAYERS.get(a, c.num_layers))
              for a, c in full.items()},
        depth={a: c.num_layers for a, c in full.items()})


def seeded_batch(vocab: int, B: int, S: int, seed: int, dev) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, vocab, (B, S))).to(dev)
            for k in ("tokens", "labels")}


def media_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """``seeded_batch``, the audio family's tokens replaced by seeded
    frames, and the vlm's image context added (``media_kw``)."""
    batch = seeded_batch(cfg.vocab, B, S, seed, dev)
    if cfg.family == "audio":
        batch["frames"] = seeded_frames(B, S, seed + 1, dev)
        del batch["tokens"]
    batch.update(media_kw(cfg, B, seed + 1, dev))
    return batch


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in the L2 norm, computed on the CPU in
    float64."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def loss_and_grads(lm, batch) -> tuple:
    named = list(lm.named_parameters())
    for _, p in named:
        p.requires_grad_(True)
    loss = lm.loss(batch)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), dict(zip((n for n, _ in named), grads))


def train_card_against_cpu(cfg, dev, seed: int, label: str = "(a)",
                           params_tol: float = TRAIN_TOL) -> dict:
    """(a) the loss, every gradient and the parameters after
    TRAIN_PARITY_STEPS AdamW steps, on the card against the CPU from the
    same weights and batch, the loss and gradients to TRAIN_TOL, the
    parameters to ``params_tol``; ``label`` names the check in the
    printout (phase 14's is (d))."""
    from repro_torch.models.model import LM
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    card = LM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    batch = media_batch(cfg, 4, 32, seed, "cpu")
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    (l_cpu, g_cpu), (l_card, g_card) = (loss_and_grads(cpu, batch),
                                        loss_and_grads(card, card_batch))
    errs = dict(loss=rel_l2(l_card, l_cpu),
                grads=max(rel_l2(g_card[n], g) for n, g in g_cpu.items()))
    opt = AdamWConfig(warmup_steps=1, total_steps=10)
    states = []
    for lm, b in ((cpu, batch), (card, card_batch)):
        step, state = make_train_step(lm, opt), init_train_state(lm)
        for _ in range(TRAIN_PARITY_STEPS):
            state, _ = step(state, b)
        states.append(state)
    errs["params"], errs["worst"] = max(
        (rel_l2(states[1].params[n], p), n)
        for n, p in states[0].params.items())
    check(errs["loss"] <= TRAIN_TOL and errs["grads"] <= TRAIN_TOL
          and errs["params"] <= params_tol,
          f"{label} {cfg.name}: the card differs from the CPU: {errs}")
    print(f"  {label} {cfg.name} float32 (capacity factor "
          f"{cfg.moe.capacity_factor if cfg.moe else '-'}): card against "
          f"CPU, |card - cpu| / |cpu| per tensor: loss {errs['loss']:.3g}, "
          f"gradients <= {errs['grads']:.3g} (tol {TRAIN_TOL}), parameters "
          f"after {TRAIN_PARITY_STEPS} AdamW steps <= {errs['params']:.3g} "
          f"({errs['worst']}; tol {params_tol}); loss {float(l_card):.6f}")
    return errs


@contextlib.contextmanager
def deterministic_mode():
    """``torch.use_deterministic_algorithms(True)`` for a ``with`` block.
    cuBLAS needs CUBLAS_WORKSPACE_CONFIG from before its first call."""
    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == CUBLAS_DETERMINISTIC,
          f"CUBLAS_WORKSPACE_CONFIG is not {CUBLAS_DETERMINISTIC}: set it "
          f"before the first CUDA call")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def train_bit_equal(cfg, dev, seed: int) -> dict:
    """(a) two card runs of TRAIN_BIT_STEPS steps from the same seed, in
    deterministic mode: bit-equal parameters and moments."""
    from repro_torch.models.model import LM
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    runs = []
    with deterministic_mode():
        for _ in range(2):
            lm = LM(cfg, device=dev,
                    generator=torch.Generator(dev).manual_seed(seed))
            step, state = make_train_step(lm, AdamWConfig()), \
                init_train_state(lm)
            for i in range(TRAIN_BIT_STEPS):
                state, m = step(state, seeded_batch(cfg.vocab, 4, 32,
                                                    seed + i, dev))
            runs.append((state, float(m["loss"])))
    (a, la), (b, lb) = runs
    same = la == lb and all(
        torch.equal(a.params[n], b.params[n])
        and torch.equal(a.opt.m[n], b.opt.m[n])
        and torch.equal(a.opt.v[n], b.opt.v[n]) for n in a.params)
    check(same, f"(a) {cfg.name}: two deterministic card runs differ")
    print(f"  (a) {cfg.name} float32 (capacity factor "
          f"{cfg.moe.capacity_factor if cfg.moe else '-'}): two card runs "
          f"of {TRAIN_BIT_STEPS} steps under "
          f"torch.use_deterministic_algorithms(True): parameters, m and v "
          f"bit-equal (loss {la:.6f})")
    return dict(bit_equal=same, loss=la)


def trainer_for(cfg, corpus, B: int, S: int, dev, ckpt: Path, steps: int,
                lr: float = 3e-4, **tcfg):
    from repro_torch.data import JoinCorpus, TokenBatcher
    from repro_torch.models.model import LM
    from repro_torch.train import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    batcher = TokenBatcher(JoinCorpus(corpus.gfjs, cfg.vocab,
                                      corpus.tokens_per_row), B, S,
                           device=dev)
    tcfg = {"checkpoint_every": 10 ** 9, "log_every": 1, **tcfg}
    return Trainer(lambda gen: LM(cfg, device=dev, generator=gen),
                   AdamWConfig(lr=lr, warmup_steps=2, total_steps=steps),
                   batcher,
                   TrainerConfig(steps=steps, checkpoint_dir=str(ckpt),
                                 **tcfg), device=dev)


def train_resume(cfg, corpus, dev) -> dict:
    """(b) the smoke model through ``Trainer`` on the card: a run that
    crashes after step 6 (checkpoints every 4) and resumes equals an
    uninterrupted run bit for bit, in deterministic mode."""
    r = TRAIN_RESUME
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    out = {}
    with deterministic_mode():
        whole = trainer_for(cfg, corpus, 4, 64, dev, CKPT_DIR / "whole",
                            r["steps"], checkpoint_every=r["checkpoint_every"])
        want = whole.run(seed=5)
        crashed = trainer_for(cfg, corpus, 4, 64, dev, CKPT_DIR / "crash",
                              r["steps"],
                              checkpoint_every=r["checkpoint_every"],
                              crash_after_step=r["crash_after_step"])
        crash = None
        try:
            crashed.run(seed=5)
        except RuntimeError as exc:
            crash = str(exc)
        check(crash == "injected failure (test)",
              f"(b) the injected failure did not fire: {crash}")
        steps_left = sorted(p.name for p in (CKPT_DIR / "crash").iterdir())
        resumed = trainer_for(cfg, corpus, 4, 64, dev, CKPT_DIR / "crash",
                              r["steps"],
                              checkpoint_every=r["checkpoint_every"])
        got = resumed.run(seed=5)
    same = int(got.opt.step) == int(want.opt.step) == r["steps"] and all(
        torch.equal(got.params[n], want.params[n])
        and torch.equal(got.opt.m[n], want.opt.m[n])
        and torch.equal(got.opt.v[n], want.opt.v[n]) for n in want.params)
    check(same, "(b) the resumed run differs from the uninterrupted one")
    out.update(bit_equal=same, checkpoints_at_crash=steps_left,
               losses=[m["loss"] for m in resumed.metrics_log])
    print(f"  (b) {cfg.name} ({cfg.param_dtype}) through Trainer on the "
          f"card: {r['steps']} steps, checkpoints every "
          f"{r['checkpoint_every']}, crash after step "
          f"{r['crash_after_step']} (left {steps_left}), resumed: "
          f"parameters, m, v and opt.step ({int(got.opt.step)}) bit-equal "
          f"to the uninterrupted run")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


def train_bounds(lm, B: int, S: int) -> dict:
    """The least time the card could take for one train step on a
    ``[B, S]`` batch: the larger of the operations over the peaks (6 per
    matrix weight per token, the MoE experts only as far as they are
    active, ``k`` per token; the causal attention's two products, forward
    and backward (3x the forward's ``4*H*hd`` per query-key pair); the
    float32 router's ``6*d*E`` per token at the float32 peak) and the
    bytes over HBM: parameters, gradients, ``m`` and ``v``, each read and
    written once.  Remat's recompute (one more forward of the blocks) is
    reported beside it, not in it."""
    from repro_torch.models.moe import MoEBlock
    cfg = lm.cfg
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim_
    T = B * S
    experts = [m for m in lm.modules() if isinstance(m, MoEBlock)]
    expert_w = {id(getattr(m, w)) for m in experts
                for w in ("router", "w_gate", "w_up", "w_down")}
    mats = sum(p.numel() for n, p in lm.named_parameters()
               if n.startswith("segments.") and p.dim() >= 2
               and id(p) not in expert_w)
    active = sum(3 * d * m.cfg.moe.d_ff_expert * m.cfg.moe.experts_per_token
                 for m in experts)
    head = d * lm.vocab_padded
    attn_fwd = 4 * H * hd * (S * (S + 1) // 2) * B * cfg.num_layers
    bf16_ops = 6 * (mats + active + head) * T + 3 * attn_fwd
    f32_ops = sum(6 * d * m.cfg.moe.num_experts * T for m in experts)
    ops_s = bf16_ops / BF16_FLOP_PER_S + f32_ops / FP32_FLOP_PER_S
    n = sum(p.numel() for p in lm.parameters())
    pbytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    state_bytes = 2 * (2 * pbytes + 8 * n)   # params, grads, m, v: r + w
    bytes_s = state_bytes / HBM_BYTES_PER_S
    remat_ops = 2 * (mats + active) * T + attn_fwd
    return dict(step_s=max(ops_s, bytes_s),
                bound_by="operations" if ops_s > bytes_s else "bytes",
                ops=bf16_ops, f32_ops=f32_ops, ops_s=ops_s,
                bytes=state_bytes, bytes_s=bytes_s, remat_ops=remat_ops,
                remat_s=remat_ops / BF16_FLOP_PER_S, params=n,
                param_bytes=pbytes)


def train_full(cfg, corpus, dev, steps: int, B: int, S: int,
               depth: int, profiled: int) -> tuple:
    """(c) / (d): ``Trainer`` on the card over join-fed batches; the
    losses, ms per step, tokens/s, busy share, peak bytes and bound.
    Returns (results, trainer, state)."""
    from repro_torch.train import make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak(dev)
    trainer = trainer_for(cfg, corpus, B, S, dev, CKPT_DIR / "full", steps,
                          lr=TRAIN_LR)
    state, wall = timed(lambda: trainer.run(seed=0), dev)
    lm = trainer.lm
    losses = [m["loss"] for m in trainer.metrics_log]
    norms = [m["grad_norm"] for m in trainer.metrics_log]
    check(len(losses) == steps and all(np.isfinite(losses + norms)),
          f"{cfg.name}: a loss or grad_norm is not finite: {losses} {norms}")
    times = trainer.step_seconds[1:][-TRAIN_TIMED_STEPS:]
    step_s = float(np.median(times))
    out = dict(layers=cfg.num_layers, of_layers=depth, steps=steps,
               batch=B, seq=S, losses=losses, grad_norms=norms,
               step_seconds=trainer.step_seconds, step_s=step_s,
               tokens_per_s=B * S / step_s, run_s=wall,
               peak_device_bytes=peak_bytes(dev),
               bound=train_bounds(lm, B, S))
    # the card's busy share of ``profiled`` more steps
    step = make_train_step(lm, trainer.opt_cfg)
    batches = [trainer.batcher.next_batch() for _ in range(profiled)]

    def loop():
        nonlocal state
        for b in batches:
            state, _ = step(state, b)

    _, loop_s = timed(loop, dev)
    events, profile_s = timed(lambda: profiled_events(loop, dev, cpu=False),
                              dev)
    out["busy"] = busy_of(event_seconds(events), loop_s)
    out["kernels"] = kernel_seconds_by_name(events)
    out.update(profiled_steps=profiled, profiled_loop_s=loop_s,
               profile_s=profile_s)
    return out, trainer, state


def fmt_train(name: str, r: dict, power: str) -> str:
    b = r["bound"]
    return (f"{name}: {r['layers']} of {r['of_layers']} layers, "
            f"{b['params']} parameters ({b['param_bytes']} B), {r['steps']} "
            f"steps of {r['batch']} x {r['seq']} tokens: loss "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; "
            f"{r['step_s'] * 1e3:.3f} ms/step (median of "
            f"{min(TRAIN_TIMED_STEPS, r['steps'] - 1)}), "
            f"{r['tokens_per_s']:.1f} tokens/s; bound "
            f"{b['step_s'] * 1e3:.3f} ms by {b['bound_by']} (operations "
            f"{b['ops_s'] * 1e3:.3f} ms, state bytes {b['bytes_s'] * 1e3:.3f}"
            f" ms; remat recompute {b['remat_s'] * 1e3:.3f} ms beside it); "
            f"{r['profiled_steps']} more steps {fmt_busy(r['busy'])}; "
            f"peak device bytes {r['peak_device_bytes']}; Trainer.run "
            f"{r['run_s']:.1f}s (model built and drawn on the card), "
            f"profiled steps {r['profile_s']:.1f}s [{power}]")


def save_restore_full(state, dev, power: str) -> dict:
    """(b) granite's whole train state saved once and restored: times,
    every leaf's crc32 checked on the way back, and the restored tensors
    equal to the live ones."""
    from repro_torch.checkpoint import CheckpointManager
    tensors = [state.opt.step, *state.params.values(),
               *state.opt.m.values(), *state.opt.v.values()]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_DIR).free
    check(free > nbytes * 1.05, f"(b) the disk under {CKPT_DIR} has "
          f"{free} B free; the train state needs {nbytes} B")
    mgr = CheckpointManager(str(CKPT_DIR / "granite"), keep=1)
    path, save_s = timed(lambda: mgr.save(1, state), dev)
    leaves = len(json.loads((Path(path) / "manifest.json").read_text())[
        "leaves"])
    (back, step, _), restore_s = timed(lambda: mgr.restore(state), dev)
    check(step == 1, "(b) restored the wrong step")
    same = all(torch.equal(back.params[n], p)
               and torch.equal(back.opt.m[n], state.opt.m[n])
               and torch.equal(back.opt.v[n], state.opt.v[n])
               for n, p in state.params.items()) and \
        torch.equal(back.opt.step, state.opt.step)
    check(same, "(b) the restored granite state differs from the saved")
    del back
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"  (b) granite-moe's whole train state ({leaves} leaves, "
          f"{nbytes} B: bf16 parameters, float32 m and v): save "
          f"{save_s:.3f}s ({nbytes / save_s / 1e9:.3f} GB/s, fsynced), "
          f"restore {restore_s:.3f}s ({nbytes / restore_s / 1e9:.3f} GB/s) "
          f"with every leaf's crc32 checked; restored tensors equal the "
          f"saved ones; disk free {free} B [{power}]")
    return dict(bytes=nbytes, leaves=leaves, save_s=save_s,
                restore_s=restore_s, disk_free=free)


def run_training(cat, queries, dev, power: str) -> dict:
    """Phase 13: training on the card."""
    from repro_torch.data import JoinCorpus
    from repro_torch.kernels.expand_many import expand_many
    cfgs = train_configs()
    t0 = time.perf_counter()
    out: dict = dict(power=power)
    launches = expand_many.launches
    corpus, t_corpus = timed(lambda: JoinCorpus.build(
        cat, queries["lastfm_A1"], vocab=256, device=dev), dev)
    out["corpus_launches"] = expand_many.launches - launches
    check(out["corpus_launches"] > 0, "JoinCorpus.build launched no "
          "expand_many kernel")
    print(f"  [{power}] JoinCorpus over lastfm_A1 built on the card in "
          f"{t_corpus:.4f}s: {corpus.num_rows} rows, expand_many launches "
          f"{out['corpus_launches']}")
    t1 = time.perf_counter()
    out["parity"] = [train_card_against_cpu(c, dev, 40 + i)
                     for i, c in enumerate(cfgs["parity"])]
    out["bits"] = [train_bit_equal(c, dev, 50 + i)
                   for i, c in enumerate(cfgs["bits"])]
    out["resume"] = train_resume(cfgs["resume"], corpus, dev)
    out["small_s"] = time.perf_counter() - t1
    print(f"  (a) and (b) at smoke size: {out['small_s']:.1f}s [{power}]")

    for arch, (steps, B, S) in TRAIN_FULL.items():
        cfg = cfgs["full"][arch]
        depth = cfgs["depth"][arch]
        r, trainer, state = train_full(cfg, corpus, dev, steps, B, S, depth,
                                       TRAIN_PROFILED_STEPS[arch])
        if arch == "granite_moe_1b_a400m":
            check(r["losses"][-1] < r["losses"][0], f"(c) {cfg.name}: the "
                  f"loss did not fall over {steps} steps: {r['losses']}")
            print("  (c) " + fmt_train(cfg.name, r, power))
            r["save_restore"] = save_restore_full(state, dev, power)
        else:
            total = torch.cuda.get_device_properties(dev).total_memory \
                if dev.type == "cuda" else 0
            r["device_total_bytes"] = total
            r["reduced"] = (f"num_layers {depth} -> {cfg.num_layers}: "
                            f"parameters, gradients, m and v of all "
                            f"{depth} layers (2 + 2 + 4 + 4 B a parameter) "
                            f"do not fit one card")
            check(dev.type != "cuda"
                  or total - r["peak_device_bytes"] >= TRAIN_FREE,
                  f"(d) {cfg.name}: peak {r['peak_device_bytes']} B leaves "
                  f"less than {TRAIN_FREE} B of {total} free")
            print("  (d) " + fmt_train(cfg.name, r, power))
            print(f"  (d) reduced: {r['reduced']}; peak leaves "
                  f"{total - r['peak_device_bytes']} B of {total} free")
        print("      card time by kernel over the profiled steps (s): "
              + ", ".join(f"{k} {v[0]:.6f} x{v[1]}"
                          for k, v in r["kernels"].items()))
        out[arch] = r
        del trainer, state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.1f}s [{power}]")
    return out


# -- phase 14: the recurrent families ----------------------------------------

REC_ARCHS = ("zamba2_2p7b", "xlstm_350m")
# (a) at full width: one unit and a tail of each (zamba2 6 Mamba2 layers
# a unit, its shared block at the head; xLSTM an mLSTM + sLSTM unit)
REC_WIDTH_LAYERS = {"zamba2_2p7b": 7, "xlstm_350m": 3}
# (d) the parameters after two AdamW steps, card against CPU: Adam divides
# each element by its own gradient's scale, so an element whose gradient
# is small beside its tensor's (zamba2's smoke A_log, 8 elements, zero at
# the start) carries that gradient's larger relative rounding error into
# an O(lr) move.  adam_noise_floor prints what a rounding-sized change of
# every gradient does on the host alone.  1e-4, as tests/test_torch_train.py
# holds Adam-stepped parameters between two implementations; the loss and
# gradients stay at TRAIN_TOL
REC_PARAMS_TOL = 1e-4
ADAM_NOISE = 2e-6          # the control's relative change of each gradient


def recurrent_configs() -> dict:
    """Phase 14's configurations per architecture: (a) full width, float32,
    REC_WIDTH_LAYERS layers; (b) and (d) the smoke variant in float32; (c)
    the full configuration (bf16, every layer)."""
    from repro_torch.configs import get_config, get_smoke
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    out = {}
    for arch in REC_ARCHS:
        full = get_config(arch)
        out[arch] = dict(
            width=full.scaled(num_layers=REC_WIDTH_LAYERS[arch], **f32),
            smoke=get_smoke(arch).scaled(**f32), full=full,
            depth=full.num_layers)
    return out


def adam_noise_floor(cfg, seed: int) -> dict:
    """(d)'s control, on the host: train_card_against_cpu's CPU run, and
    the same run with every gradient scaled by ``1 + ADAM_NOISE *
    N(0, 1)``: the largest per-tensor |diff| / |plain| of the parameters
    after TRAIN_PARITY_STEPS AdamW steps, and its tensor."""
    from repro_torch.models.model import LM
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    batch = seeded_batch(cfg.vocab, 4, 32, seed, "cpu")
    noise = torch.Generator().manual_seed(seed)
    states = []
    for scale in (0.0, ADAM_NOISE):
        lm = LM(cfg, device="cpu",
                generator=torch.Generator().manual_seed(seed))
        for p in lm.parameters():
            p.requires_grad_(True)
            if scale:
                p.register_hook(lambda g: g * (1 + scale * torch.randn(
                    g.shape, generator=noise)))
        step, state = make_train_step(lm, AdamWConfig(
            warmup_steps=1, total_steps=10)), init_train_state(lm)
        for _ in range(TRAIN_PARITY_STEPS):
            state, _ = step(state, batch)
        states.append(state)
    err, name = max((rel_l2(states[1].params[n], p), n)
                    for n, p in states[0].params.items())
    print(f"  (d) control, on the host: every gradient scaled by 1 + "
          f"{ADAM_NOISE} N(0, 1) moves the parameters after "
          f"{TRAIN_PARITY_STEPS} AdamW steps by <= {err:.3g} ({name})")
    return dict(params=err, worst=name)


def run_recurrent(cat, queries, dev, power: str) -> dict:
    """Phase 14: the hybrid (zamba2) and ssm (xLSTM) families on the
    card."""
    cfgs = recurrent_configs()
    t0 = time.perf_counter()
    out: dict = dict(power=power)
    for i, arch in enumerate(REC_ARCHS):
        c = cfgs[arch]
        t1 = time.perf_counter()
        row = dict(width=lm_width_consistency(c["width"], dev))
        print(f"  (a) {arch}: {c['width'].num_layers} of {c['depth']} "
              f"layers (reduced: one unit and a tail)")
        gc.collect()
        torch.cuda.empty_cache()
        row["smoke"] = lm_card_against_cpu([c["smoke"]], dev)
        _, _, row["smoke"]["bit_equal"] = card_runs_equal(c["smoke"], dev,
                                                          60 + i)
        print(f"  (b) {c['smoke'].name}: two card runs (forward, prefill, 7 "
              f"decode steps) bit-equal")
        row["full"] = lm_serving(cat, queries["lastfm_A1"], c["full"], dev)
        gc.collect()
        torch.cuda.empty_cache()
        row["train"] = train_card_against_cpu(
            c["smoke"], dev, 70 + i, label="(d)", params_tol=REC_PARAMS_TOL)
        row["train"]["noise_floor"] = adam_noise_floor(c["smoke"], 70 + i)
        row["seconds"] = time.perf_counter() - t1
        print(f"  {arch}: {row['seconds']:.1f}s [{power}]")
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = row
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.1f}s [{power}]")
    return out


# -- phase 15: the vlm and audio families -----------------------------------

MEDIA_ARCHS = ("llama32_vision_11b", "hubert_xlarge")
# (a) at full width: Llama-3.2-Vision one unit (4 self-attention layers
# and a cross layer) and one tail layer; HuBERT 2 of its 48 blocks
MEDIA_WIDTH_LAYERS = {"llama32_vision_11b": 6, "hubert_xlarge": 2}
# (a) HuBERT, card against CPU: the dense path, then the online one
ENCODER_WIDTH_BATCHES = ((2, 256), (1, 3072))
ENCODE_PROFILED = 1        # (c) encodes under the profiler


def media_configs() -> dict:
    """Phase 15's configurations per architecture: (a) full width,
    float32, MEDIA_WIDTH_LAYERS layers; (b) and (d) the smoke variant in
    float32; (c) the full configuration (bf16, every layer)."""
    from repro_torch.configs import get_config, get_smoke
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    out = {}
    for arch in MEDIA_ARCHS:
        full = get_config(arch)
        out[arch] = dict(
            width=full.scaled(num_layers=MEDIA_WIDTH_LAYERS[arch], **f32),
            smoke=get_smoke(arch).scaled(**f32), full=full,
            depth=full.num_layers)
    return out


def encoder_width(cfg, dev) -> dict:
    """(a) HuBERT at full width in float32: the card's forward against
    the CPU's on the same weights and frames (ENCODER_WIDTH_BATCHES: the
    dense path, then the online one) to LM_CARD_TOL, and non-causality on
    the card: another last frame moves position 0's logits."""
    from repro_torch.models.model import LM
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(40))
    card = LM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    out: dict = dict(param_bytes=card.param_bytes())
    for i, (B, S) in enumerate(ENCODER_WIDTH_BATCHES):
        fr = seeded_frames(B, S, 41 + i, "cpu")
        moved = fr.clone()
        moved[:, -1] = seeded_frames(B, 1, 51 + i, "cpu")[:, 0]
        with torch.inference_mode():
            want = cpu(fr)
            got = card(fr.to(dev))
            shift = card(moved.to(dev))
        err = float((got.cpu() - want).abs().max())
        check(torch.allclose(got.cpu(), want, atol=LM_CARD_TOL,
                             rtol=LM_CARD_TOL),
              f"(a) {cfg.name} {B} x {S}: the card's logits differ from "
              f"the CPU's by {err}")
        first = float((shift[:, 0] - got[:, 0]).abs().max())
        check(first > 1e-4, f"(a) {cfg.name} {B} x {S}: position 0 does "
              f"not see the last frame (moved by {first}): causal?")
        out[f"{B}x{S}"] = dict(max_err=err, first_moved=first)
        print(f"  (a) {cfg.name} at full width, {cfg.num_layers} layers, "
              f"float32 ({out['param_bytes']} B), {B} x {S} frames ("
              + ("online" if S * S > (1 << 22) else "dense") + " path): "
              f"logits on the card against the CPU, max |diff| {err:.3g} "
              f"(tol {LM_CARD_TOL}); another last frame moves position 0's "
              f"logits by {first:.3g} (non-causal)")
    return out


def encoder_card_runs(cfg, dev, seed: int) -> dict:
    """(b) the smoke encoder on the card against the CPU (forward logits
    to LM_CARD_TOL) and two card runs bit-equal."""
    from repro_torch.models.model import LM
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(
        seed))
    card = LM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    fr = seeded_frames(3, 16, seed, "cpu")
    with torch.inference_mode():
        want = cpu(fr)
        runs = [card(fr.to(dev)) for _ in range(2)]
    err = float((runs[0].cpu() - want).abs().max())
    check(torch.allclose(runs[0].cpu(), want, atol=LM_CARD_TOL,
                         rtol=LM_CARD_TOL),
          f"(b) {cfg.name}: the card's logits differ from the CPU's by {err}")
    same = torch.equal(runs[0], runs[1])
    check(same, f"(b) {cfg.name}: two card runs differ")
    print(f"  (b) {cfg.name} float32: forward logits on the card against "
          f"the CPU, max |diff| {err:.3g} (tol {LM_CARD_TOL}); two card "
          f"runs bit-equal")
    return {cfg.name: dict(max_err=err), "bit_equal": same}


def encoder_serving(cfg, dev, prov, table) -> dict:
    """(c) the full encoder in bf16 encoding seeded frames through
    ``make_serve_step(lm, mode="prefill")`` at LM_BATCHES, each request's
    features from ``prov`` (held against ``table``, the GROUP BY on
    ``device="cpu"``): two encodes bit-equal, finite logits of the
    expected shape; encode seconds and frames/s beside ``lm_bounds``; the
    busy share of ENCODE_PROFILED encodes with kernel seconds by name;
    peak device bytes."""
    from repro_torch.models.model import LM
    from repro_torch.serve import ServeConfig, ServeEngine, lookup_rows, \
        make_serve_step
    out: dict = {}
    reset_peak(dev)
    lm, t_build = timed(lambda: LM(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(0)), dev)
    out["param_bytes"] = lm.param_bytes()
    out["params"] = sum(p.numel() for p in lm.parameters())
    print(f"  (c) {cfg.name}: {cfg.num_layers} layers, {out['params']} "
          f"parameters, {out['param_bytes']} B in {cfg.param_dtype}, built "
          f"and drawn on the card in {t_build:.3f}s")
    encode = make_serve_step(lm, mode="prefill")
    users = np.asarray(table["U1"])
    for i, (B, S) in enumerate(LM_BATCHES):
        row = {"requests": B, "frames": S}
        keys = np.random.default_rng(300 + i).choice(users, B)
        engine = ServeEngine(lm, ServeConfig(max_seq=S),
                             feature_provider=prov, device=dev)
        batch, t_feat = timed(lambda: engine.attach_features(
            {"frames": seeded_frames(B, S, 310 + i, dev)}, keys), dev)
        feats = batch["features"].cpu().numpy()
        check(np.array_equal(feats, lookup_rows(table, "U1", ["n_paths"],
                                                keys)),
              "(c) the provider's features differ from group_by on "
              "device='cpu'")
        with torch.inference_mode():
            first = encode(batch["frames"])            # warms the card
            second, t_enc = timed(lambda: encode(batch["frames"]), dev)
            same = torch.equal(first, second)
            check(same, f"(c) {B} x {S}: two encodes differ")
            check(tuple(second.shape) == (B, S, lm.vocab_padded)
                  and bool(torch.isfinite(second[..., :cfg.vocab]).all()),
                  f"(c) {B} x {S}: logits not finite or of another shape")
            del first, second

            def loop():
                for _ in range(ENCODE_PROFILED):
                    encode(batch["frames"])
            _, wall = timed(loop, dev)
            events = profiled_events(loop, dev)
        bound = lm_bounds(lm, B, S, 1)
        row.update(features=feats[:, 0].tolist(), users=keys.tolist(),
                   feature_s=t_feat, encode_s=t_enc,
                   frames_per_s=B * S / t_enc, bound=bound, bit_equal=same,
                   busy=busy_of(event_seconds(events), wall),
                   kernels=kernel_seconds_by_name(events))
        print(f"  (c) {B} x {S} frames: features {row['features']} for "
              f"users {row['users']} in {t_feat:.4f}s, equal to group_by on "
              f"the CPU; encode {t_enc:.4f}s, {B * S / t_enc:.1f} frames/s, "
              f"bound {bound['encode_s']:.4f}s by "
              f"{bound['encode_bound_by']} (2 x all parameters x frames / "
              f"bf16 peak: {bound['coarse_encode_s']:.4f}s); two encodes "
              f"bit-equal; {ENCODE_PROFILED} encode(s) "
              f"{fmt_busy(row['busy'])}")
        print(f"      the encode's card time by kernel (s): "
              + ", ".join(f"{k} {v[0]:.6f} x{v[1]}" for k, v in
                          row["kernels"].items()))
        out[f"{B}x{S}"] = row
        del batch
    out["peak_device_bytes"] = peak_bytes(dev)
    print(f"  (c) peak device bytes {out['peak_device_bytes']} (parameters "
          f"{out['param_bytes']})")
    del lm
    return out


def run_media(cat, queries, dev, power: str) -> dict:
    """Phase 15: the vlm (Llama-3.2-Vision) and audio (HuBERT) families
    on the card."""
    from repro_torch.serve import RelationalFeatureProvider
    from repro_torch.summary import JoinService
    from repro_torch.summary.algebra import SummaryFrame
    cfgs = media_configs()
    query = queries["lastfm_A1"]
    t0 = time.perf_counter()
    out: dict = dict(power=power)
    prov = RelationalFeatureProvider(JoinService(cat, device=dev), query,
                                     key_var="U1", aggs={"n_paths": "count"})
    for i, arch in enumerate(MEDIA_ARCHS):
        c = cfgs[arch]
        t1 = time.perf_counter()
        if c["full"].family == "vlm":
            row = dict(width=lm_width_consistency(c["width"], dev))
        else:
            row = dict(width=encoder_width(c["width"], dev))
        print(f"  (a) {arch}: {c['width'].num_layers} of {c['depth']} "
              f"layers (reduced: depth)")
        gc.collect()
        torch.cuda.empty_cache()
        if c["full"].family == "vlm":
            row["smoke"] = lm_card_against_cpu([c["smoke"]], dev)
            _, _, row["smoke"]["bit_equal"] = card_runs_equal(
                c["smoke"], dev, 80 + i)
            print(f"  (b) {c['smoke'].name}: two card runs (forward, "
                  f"prefill, 7 decode steps) bit-equal")
            row["full"] = lm_serving(cat, query, c["full"], dev, prov=prov)
        else:
            row["smoke"] = encoder_card_runs(c["smoke"], dev, 80 + i)
            table = SummaryFrame.of(prov.service.frame(query).frame.gfjs,
                                    device="cpu").group_by(
                ["U1"], n_paths="count")
            row["full"] = encoder_serving(c["full"], dev, prov, table)
        gc.collect()
        torch.cuda.empty_cache()
        row["train"] = train_card_against_cpu(c["smoke"], dev, 90 + i,
                                              label="(d)")
        row["seconds"] = time.perf_counter() - t1
        print(f"  {arch}: {row['seconds']:.1f}s [{power}]")
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = row
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.1f}s [{power}]")
    return out


# -- phase 16: data parallelism across ranks ---------------------------------

DP_ARCH = "granite_moe_1b_a400m"    # (a): phase 13's model, batch and lr
DP_BATCH = TRAIN_FULL[DP_ARCH][1:]  # 8 x 1,024, split over the ranks
DP_STEPS = 3
DP_SEED = 16
DP_LOSS_GAP = 0.05   # compressed against uncompressed loss, each step:
                     # tests/test_dist.py's gate
# (a) at a world of W cards: the DP parameters against the one-card step
# with W microbatches (each a rank's rows: an MoE's capacity, and so its
# drops, follow the rows a call sees), |a - b| / |b| (L2, per tensor).
# The all-reduce may add the W float32 gradients in another order than the
# microbatch loop, and a change in the last bit of an update can flip the
# bf16 rounding of a parameter: one bf16 step, 2^-8, in every element at
# most
# most.  Rehearsed over 4 gloo ranks on the CPU (tests/test_torch_dp.py's
# test_bf16_dp_steps_match_the_microbatched_step, granite's smoke config,
# 3 steps): 1.06e-8
DP_WORLD_TOL = 2.0 ** -8
DP_GNORM_RTOL = 1e-5  # the grad norm against the one-rank step's, relative
DP_SMOKE_TOL = 2e-5  # (b) max |DP - one rank|: tests/test_dist.py's gate
# (b)'s AdamW: grad_clip 0 as tests/test_dist.py, but the warmup's first
# step at the full lr (3e-4): Adam's first update is about lr in every
# element, its sign the reduced gradient's, so a wrong all-reduce moves
# the parameters far past the gate (and a wrong scale shows in the norm)
DP_SMOKE_OPT = dict(grad_clip=0.0, warmup_steps=1)
DP_SMOKE_BATCH = (8, 16)
DP_HIST_K = (2, 4, 7)
DP_HIST_SALT = 3
DP_JOIN_S = {"a": 200, "b": 100}    # each part's ranks, spawn to join
DP_COLLECTIVE_S = 120               # one collective's timeout in a rank
DP_DIR = ROOT / "build" / "phase16"


def dp_configs() -> dict:
    """Phase 16's configurations: (a) granite-moe at full size, as phase
    13 (c); (b) the qwen3_8b smoke config at 2 layers in float32, as
    tests/test_dist.py."""
    from repro_torch.configs import get_config, get_smoke
    return dict(a=get_config(DP_ARCH), b=get_smoke("qwen3_8b").scaled(
        num_layers=2, param_dtype="float32", compute_dtype="float32"))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(spec: dict) -> list:
    """Run ``spec["world"]`` ranks of ``dp_rank`` (``launch/ranks.py``:
    spawned, joined by DP_JOIN_S, what is left killed; a rank that failed
    or hung fails the phase).  Returns each rank's results."""
    from repro_torch.launch.ranks import run_ranks
    run_ranks(dp_rank, spec["world"], (spec,),
              timeout_s=DP_JOIN_S[spec["part"]])
    return [torch.load(DP_DIR / f"{spec['part']}{r}.pt", weights_only=False)
            for r in range(spec["world"])]


def dp_rank(rank: int, spec: dict) -> None:
    """One spawned rank of phase 16: joins the world on ``spec``'s backend
    and address, builds the ``("data",)`` mesh on ``spec``'s device, runs
    its part and writes the results for the parent."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        spec["backend"], init_method=spec["init"], rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=DP_COLLECTIVE_S))
    try:
        mesh = make_mesh((spec["world"],), ("data",), device=spec["device"])
        part = dp_part_a if spec["part"] == "a" else dp_part_b
        out = part(rank, spec, mesh, dev)
        out["hist"] = dp_histograms(rank, spec["world"], mesh, dev)
        torch.save(out, DP_DIR / f"{spec['part']}{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_histograms(rank: int, world: int, mesh, dev) -> dict:
    """This rank's contiguous slice of lastfm_A1's A1 column through the
    cross-rank ``partition_histogram``; the global counts and seconds."""
    from repro_torch.dist.partition import partition_histogram
    codes = np.load(DP_DIR / "a1.npy", mmap_mode="r")
    lo, hi = len(codes) * rank // world, len(codes) * (rank + 1) // world
    part = torch.from_numpy(np.array(codes[lo:hi])).to(dev)
    out = dict(rows=(lo, hi))
    for k in DP_HIST_K:
        hist, s = timed(lambda: partition_histogram(
            part, k, salt=DP_HIST_SALT, device=dev, mesh=mesh), dev)
        out[k] = (hist.cpu().numpy(), s)
    return out


def dp_steps(step, state, batches, dev) -> tuple:
    """Run ``step`` over ``batches``: (state, (losses, grad norms), seconds
    a step)."""
    losses, norms, seconds = [], [], []
    for b in batches:
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        seconds.append(time.perf_counter() - t0)
    return state, (losses, norms), seconds


def ms_list(seconds) -> str:
    return " / ".join(f"{s * 1e3:.3f}" for s in seconds)


def dp_part_a(rank: int, spec: dict, mesh, dev) -> dict:
    """(a) granite-moe at full size: the one-card step (rank 0; a
    microbatch a rank) against the uncompressed DP step (deterministic
    mode), then compressed DP steps,
    one profiled, and the compressed all-reduce of one step's gradients
    alone, profiled."""
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, compressed_psum,
                                   init_train_state, make_dp_shard_map_step,
                                   make_train_step)
    cfg, world = spec["cfg"], spec["world"]
    ocfg = AdamWConfig(**spec["opt"])
    whole = [{k: v.to(dev) for k, v in b.items()}
             for b in torch.load(DP_DIR / "batches.pt")]
    rows = whole[0]["tokens"].shape[0] // world
    local = [{k: v[rank * rows:(rank + 1) * rows] for k, v in b.items()}
             for b in whole]

    def build():
        return LM(cfg, device=dev,
                  generator=torch.Generator(dev).manual_seed(DP_SEED))

    out: dict = dict(rows=rows)
    with deterministic_mode():
        if rank == 0:
            lm = build()
            state, (out["one_losses"], out["one_norms"]), out["one_s"] = \
                dp_steps(
                make_train_step(lm, ocfg, microbatches=world),
                init_train_state(lm), whole, dev)
            want = {n: p.detach().clone() for n, p in state.params.items()}
            del lm, state
            gc.collect()
            torch.cuda.empty_cache()
        lm = build()
        out["params"] = sum(p.numel() for p in lm.parameters())
        init, step = make_dp_shard_map_step(lm, ocfg, mesh, compress=False)
        state, (out["exact_losses"], out["exact_norms"]), out["exact_s"] = \
            dp_steps(step, init(init_train_state(lm).params), local, dev)
    if rank == 0:
        out["bit_equal"] = all(torch.equal(state.params[n], p)
                               for n, p in want.items())
        out["rel_l2"] = 0.0 if out["bit_equal"] else max(
            rel_l2(state.params[n], p) for n, p in want.items())
        del want
    del lm, state
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak(dev)
    lm = build()
    init, step = make_dp_shard_map_step(lm, ocfg, mesh, compress=True)
    state, (out["comp_losses"], _), out["comp_s"] = dp_steps(
        step, init(init_train_state(lm).params), local, dev)
    out["residual_finite"] = all(bool(torch.isfinite(r).all())
                                 for r in state.residual.values())

    def one_step():
        nonlocal state
        state, _ = step(state, local[-1])

    _, wall = timed(one_step, dev)
    events = profiled_events(one_step, dev, cpu=False)
    out["busy"] = busy_of(event_seconds(events), wall)
    out["step_kernels"] = kernel_seconds_by_name(events)
    out["peak_device_bytes"] = peak_bytes(dev)
    # the compressed all-reduce of one step's gradients, alone
    _, grads = loss_and_grads(lm, local[0])
    group = mesh.get_group("data")

    def reduce():
        for n, g in grads.items():
            compressed_psum(g, group, state.residual[n])

    reduce()
    _, out["reduce_s"] = timed(reduce, dev)
    out["reduce_kernels"] = kernel_seconds_by_name(
        profiled_events(reduce, dev, cpu=False), top=12)
    return out


def dp_part_b(rank: int, spec: dict, mesh, dev) -> dict:
    """(b) the smoke model's uncompressed DP step on this rank's rows, and
    ``compressed_psum`` of card tensors against the same arrays on the
    CPU, both over the one gloo group."""
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, compressed_psum,
                                   init_train_state, make_dp_shard_map_step)
    cfg, world = spec["cfg"], spec["world"]
    batch = torch.load(DP_DIR / "smoke_batch.pt")
    rows = batch["tokens"].shape[0] // world
    local = {k: v[rank * rows:(rank + 1) * rows].to(dev)
             for k, v in batch.items()}
    lm = LM(cfg, device=dev,
            generator=torch.Generator(dev).manual_seed(DP_SEED))
    init, step = make_dp_shard_map_step(lm, AdamWConfig(**DP_SMOKE_OPT),
                                        mesh, compress=False)
    state, m = step(init(init_train_state(lm).params), local)
    out = dict(rows=rows, loss=float(m["loss"]),
               grad_norm=float(m["grad_norm"]),
               params={n: p.detach().cpu() for n, p in state.params.items()})
    group = mesh.get_group("data")
    rng = np.random.default_rng(DP_SEED + rank)
    psum = {}
    for shape, with_res in (((33, 7), True), ((4096,), False)):
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        r = torch.from_numpy((rng.standard_normal(shape) * 1e-2).astype(
            np.float32)) if with_res else None
        card = compressed_psum(g.to(dev), group,
                               None if r is None else r.to(dev))
        cpu = compressed_psum(g, group, r)
        psum[shape] = all(torch.equal(a.cpu(), b)
                          for a, b in zip(card, cpu))
    out["psum_bit_equal"] = psum
    return out


def dp_run_b(cfg, want: dict, dev) -> dict:
    """(b): two gloo ranks on the one card against the one-rank step on
    the whole batch; each rank's histogram of DP_DIR's codes against
    ``want``."""
    from repro_torch.models.model import LM
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    t1 = time.perf_counter()
    batch = seeded_batch(cfg.vocab, *DP_SMOKE_BATCH, DP_SEED, "cpu")
    torch.save(batch, DP_DIR / "smoke_batch.pt")
    ranks = spawn_ranks(dict(part="b", backend="gloo", device=dev.type,
                             world=2, init=f"tcp://localhost:{free_port()}",
                             cfg=cfg))
    lm = LM(cfg, device=dev,
            generator=torch.Generator(dev).manual_seed(DP_SEED))
    p0 = {n: p.detach().clone() for n, p in lm.named_parameters()}
    state, m = make_train_step(lm, AdamWConfig(**DP_SMOKE_OPT))(
        init_train_state(lm), {k: v.to(dev) for k, v in batch.items()})
    moved = max(float((p.detach() - p0[n]).abs().max())
                for n, p in state.params.items())
    diff = max(float((r["params"][n].to(dev) - p.detach()).abs().max())
               for r in ranks for n, p in state.params.items())
    loss_gap = max(abs(r["loss"] - float(m["loss"])) for r in ranks)
    norm_gap = max(abs(r["grad_norm"] / float(m["grad_norm"]) - 1)
                   for r in ranks)
    check(moved > 10 * DP_SMOKE_TOL, f"(b) the one-rank step moves the "
          f"parameters {moved:.3g}, too little for the gate {DP_SMOKE_TOL}")
    check(diff < DP_SMOKE_TOL, f"(b) DP over 2 gloo ranks is {diff:.3g} "
          f"from the one-rank step (> {DP_SMOKE_TOL})")
    check(loss_gap < DP_SMOKE_TOL, f"(b) losses {[r['loss'] for r in ranks]}"
          f" vs {float(m['loss'])}")
    check(norm_gap <= DP_GNORM_RTOL, f"(b) grad norms "
          f"{[r['grad_norm'] for r in ranks]} vs {float(m['grad_norm'])}")
    check(all(all(r["psum_bit_equal"].values()) for r in ranks),
          f"(b) compressed_psum on the card vs the CPU: "
          f"{[r['psum_bit_equal'] for r in ranks]}")
    for r in ranks:
        for k in DP_HIST_K:
            check(np.array_equal(r["hist"][k][0], want[k]),
                  f"(b) cross-rank partition_histogram k={k} vs numpy")
    b = dict(seconds=time.perf_counter() - t1, max_diff=diff, moved=moved,
             loss=ranks[0]["loss"], one_loss=float(m["loss"]),
             loss_gap=loss_gap, norm_gap=norm_gap,
             hist_s={k: ranks[0]["hist"][k][1] for k in DP_HIST_K})
    del lm, state
    print(f"  (b) world 2 over gloo, CUDA tensors on the one card: "
          f"{cfg.name} (2 layers, float32), one uncompressed DP step of "
          f"{DP_SMOKE_BATCH[0]} x {DP_SMOKE_BATCH[1]} ({ranks[0]['rows']} "
          f"rows a rank): {diff:.3g} from the one-rank step on the whole "
          f"batch (gate {DP_SMOKE_TOL}; the step moves the parameters "
          f"{moved:.3g}), loss {loss_gap:.3g} and grad norm {norm_gap:.3g} "
          f"(relative) apart; compressed_psum of card tensors bit-equal to "
          f"the CPU's on both ranks; the histogram of (a) over 2 ranks "
          f"equal to numpy ({b['seconds']:.1f}s)")
    return b


def run_data_parallel(cat, queries, mono_a1, dev, power: str) -> dict:
    """Phase 16: data parallelism across ranks, the ranks spawned: (a) one
    NCCL rank per card, (b) two gloo ranks on the one card."""
    from repro_torch.core import engine
    from repro_torch.data import JoinCorpus, TokenBatcher
    from repro_torch.dist.partition import hash_partition, partition_histogram
    t0 = time.perf_counter()
    cfgs = dp_configs()
    out: dict = dict(power=power)
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    corpus = JoinCorpus.build(cat, queries["lastfm_A1"], vocab=256,
                              device=dev)
    batcher = TokenBatcher(JoinCorpus(corpus.gfjs, cfgs["a"].vocab,
                                      corpus.tokens_per_row), *DP_BATCH,
                           device=dev)
    torch.save([{k: v.cpu() for k, v in batcher.next_batch().items()}
                for _ in range(DP_STEPS)], DP_DIR / "batches.pt")
    del corpus, batcher
    col = engine.desummarize(mono_a1, decode=False, device=dev)["A1"]
    codes = col.cpu().numpy()
    np.save(DP_DIR / "a1.npy", codes)
    want = {}
    for k in DP_HIST_K:
        want[k] = np.bincount(hash_partition(codes, k, salt=DP_HIST_SALT),
                              minlength=k)
        one = partition_histogram(col, k, salt=DP_HIST_SALT, device=dev)
        check(np.array_equal(one.cpu().numpy(), want[k]),
              f"one-device partition_histogram k={k} vs numpy")
    out["hist_want"] = {k: v.tolist() for k, v in want.items()}
    del col
    gc.collect()
    torch.cuda.empty_cache()

    # (a) one NCCL rank per card
    world = torch.cuda.device_count()
    print(f"  (a) world {world}: one NCCL rank per card "
          f"(torch.cuda.device_count() = {world})")
    check(DP_BATCH[0] % world == 0, f"(a) {DP_BATCH[0]} rows do not split "
          f"over {world} ranks")
    t1 = time.perf_counter()
    ranks = spawn_ranks(dict(
        part="a", backend="nccl", device=dev.type, world=world,
        init=f"tcp://localhost:{free_port()}", cfg=cfgs["a"],
        opt=dict(lr=TRAIN_LR, warmup_steps=2,
                 total_steps=TRAIN_FULL[DP_ARCH][0])))
    a = ranks[0]
    a["seconds"] = time.perf_counter() - t1
    if world == 1:
        check(a["bit_equal"] and a["exact_losses"] == a["one_losses"]
              and a["exact_norms"] == a["one_norms"],
              "(a) the one-rank DP step differs from make_train_step")
    else:
        check(a["rel_l2"] <= DP_WORLD_TOL, f"(a) the DP parameters are "
              f"{a['rel_l2']:.3g} from the one-card step's (> "
              f"{DP_WORLD_TOL:.3g})")
        check(np.allclose(a["exact_norms"], a["one_norms"], atol=0,
                          rtol=DP_GNORM_RTOL), f"(a) grad norms "
              f"{a['exact_norms']} vs {a['one_norms']}")
    gaps = [abs(c - e) for c, e in zip(a["comp_losses"], a["exact_losses"])]
    check(max(gaps) < DP_LOSS_GAP, f"(a) compressed losses "
          f"{a['comp_losses']} vs {a['exact_losses']}")
    check(all(r["residual_finite"] for r in ranks),
          "(a) a residual is not finite")
    for r in ranks:
        for k in DP_HIST_K:
            check(np.array_equal(r["hist"][k][0], want[k]),
                  f"(a) cross-rank partition_histogram k={k} vs numpy")
    print(f"  (a) {cfgs['a'].name} at full size ({a['params']} parameters,"
          f" bf16), {DP_STEPS} steps of {DP_BATCH[0]} x {DP_BATCH[1]} "
          f"join-fed tokens, {a['rows']} rows a rank, AdamW lr {TRAIN_LR}: "
          f"uncompressed DP parameters "
          + ("bit-equal to make_train_step's, losses and grad norms equal"
             if world == 1 else f"{a['rel_l2']:.3g} (L2) from "
             f"make_train_step(microbatches={world})'s on one card")
          + f"; losses {a['exact_losses']}")
    print(f"  (a) compressed (int8, error feedback): losses "
          f"{a['comp_losses']}, at most {max(gaps):.3g} from the "
          f"uncompressed (gate {DP_LOSS_GAP}); residuals finite")
    print(f"  (a) ms a step (no gate; phase 13's granite step: 1,081.7-"
          f"1,097.1 ms in PERF.md §5): one card, deterministic "
          f"{ms_list(a['one_s'])}; "
          f"DP uncompressed, deterministic {ms_list(a['exact_s'])}; DP "
          f"compressed {ms_list(a['comp_s'])}; one more compressed step "
          f"{fmt_busy(a['busy'])}; peak device bytes "
          f"{a['peak_device_bytes']} [{power}]")
    print("      card time by kernel over that step (s): " + ", ".join(
        f"{k} {v[0]:.6f} x{v[1]}" for k, v in a["step_kernels"].items()))
    print(f"  (a) the compressed all-reduce of one step's gradients alone: "
          f"{a['reduce_s']:.6f}s (int32 payload {4 * a['params']} B); "
          f"by kernel (s): " + ", ".join(
              f"{k} {v[0]:.6f} x{v[1]}"
              for k, v in a["reduce_kernels"].items()))
    print(f"  (a) cross-rank partition_histogram of lastfm_A1's A1 column "
          f"({len(codes)} codes, rank 0 rows {a['hist']['rows']}), salt "
          f"{DP_HIST_SALT}: equal to np.bincount(hash_partition) and the "
          f"one-device histogram; seconds " + ", ".join(
              f"k={k} {a['hist'][k][1]:.6f}" for k in DP_HIST_K))
    out["a"] = {**{k: v for k, v in a.items() if k != "hist"},
                "world": world,
                "hist_s": {k: a["hist"][k][1] for k in DP_HIST_K}}

    # (b) two gloo ranks on the one card
    out["b"] = dp_run_b(cfgs["b"], want, dev)
    shutil.rmtree(DP_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.1f}s (a) {a['seconds']:.1f}s "
          f"[{power}]")
    return out


# -- phase 17: the sharded train step (DTensor placements) ------------------

SP_ARCH = "qwen3_8b"                 # phase 13 (d)'s model and batch
SP_BATCH = TRAIN_FULL[SP_ARCH][1:]   # 2 x 4,096 join-fed tokens
SP_STEPS = 3
SP_SEED = 17
SP_OPT = dict(lr=TRAIN_LR, warmup_steps=1)
# at a world of more than one card the model axis splits the bf16
# products, whose partial sums then add in another order; Adam turns a
# gradient's rounding into a move of about lr (a sign), so the parameters
# are not held there, each step's loss is: within tests/test_dist.py's
# gap, as phase 16's compressed steps (rehearsed over 2 gloo ranks on the
# CPU, the qwen3_8b smoke config: parameters 0.069 apart, L2 relative)
SP_LOSS_GAP = DP_LOSS_GAP
SP_JOIN_S = 150                      # the ranks, spawn to join
SP_DIR = ROOT / "build" / "phase17"


def sp_configs() -> dict:
    """Phase 17's configuration: Qwen3-8B at full width, at phase 13
    (d)'s depth (``cfg``), and its full depth."""
    train = train_configs()
    return dict(cfg=train["full"][SP_ARCH], depth=train["depth"][SP_ARCH])


def sp_rank(rank: int, spec: dict) -> None:
    """One spawned rank of phase 17: joins the world on ``spec``'s backend
    and address, runs (a) and writes the results for the parent."""
    import datetime
    import torch.distributed as dist
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        spec["backend"], init_method=spec["init"], rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=DP_COLLECTIVE_S))
    try:
        torch.save(sp_part_a(rank, spec, dev), SP_DIR / f"a{rank}.pt")
    finally:
        dist.destroy_process_group()


def sp_spawn(spec: dict) -> list:
    """Run ``spec["world"]`` ranks of ``sp_rank`` (``launch/ranks.py``:
    spawned, joined by SP_JOIN_S, what is left killed; a rank that failed
    or hung fails the phase).  Returns each rank's results."""
    from repro_torch.launch.ranks import run_ranks
    run_ranks(sp_rank, spec["world"], (spec,), timeout_s=SP_JOIN_S)
    return [torch.load(SP_DIR / f"a{r}.pt", weights_only=False)
            for r in range(spec["world"])]


def sp_part_a(rank: int, spec: dict, dev) -> dict:
    """In deterministic mode: the plain ``make_train_step`` (rank 0),
    the parameters copied to the host, the model freed and rebuilt from
    the same seed, placed by the rules on ``make_local_mesh(model=world)``
    and stepped again over the same batches; then one more placed step
    profiled."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    cfg, world = spec["cfg"], spec["world"]
    ocfg = AdamWConfig(**spec["opt"])
    mesh = make_local_mesh(model=world, device=spec["device"])
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in torch.load(SP_DIR / "batches.pt")]

    def build():
        return LM(cfg, device=dev,
                  generator=torch.Generator(dev).manual_seed(SP_SEED))

    out: dict = dict(mesh=tuple(mesh.shape))
    with deterministic_mode():
        if rank == 0:
            reset_peak(dev)
            lm = build()
            state, (out["plain_losses"], out["plain_norms"]), \
                out["plain_s"] = dp_steps(make_train_step(lm, ocfg),
                                          init_train_state(lm), batches, dev)
            out["plain_peak"] = peak_bytes(dev)
            want = {n: p.detach().cpu() for n, p in state.params.items()}
            del lm, state
            gc.collect()
            torch.cuda.empty_cache()
        reset_peak(dev)
        lm = build()
        out["params"] = sum(p.numel() for p in lm.parameters())

        def place():
            st = specs.state_shardings(lm, mesh, specs.arch_rules(cfg, mesh))
            specs.place_params(lm, st.params)
            of = specs.batch_shardings(cfg, mesh, SP_BATCH[0])
            return [{k: distribute_tensor(v, mesh, of(v).placements)
                     for k, v in b.items()} for b in batches]

        placed, out["place_s"] = timed(place, dev)
        out["sharded"] = sum(any(not p.is_replicate() for p in t.placements)
                             for t in lm.parameters())
        step = make_train_step(lm, ocfg)
        state = init_train_state(lm)
        # this rank's bytes of the state and a batch (phase 18 (d))
        out["argument_bytes"] = dryrun.local_bytes((state, placed[0]))
        state, (out["losses"], out["norms"]), out["placed_s"] = dp_steps(
            step, state, placed, dev)
        out["peak"] = peak_bytes(dev)
        full = {n: p.full_tensor() for n, p in state.params.items()}
    if rank == 0:
        same = {n: torch.equal(f.cpu(), want[n]) for n, f in full.items()}
        out["bit_equal"] = all(same.values())
        out["rel_l2"] = max([rel_l2(full[n], want[n])
                             for n, ok in same.items() if not ok] or [0.0])
        out["unequal"] = sorted(n for n, ok in same.items() if not ok)
        del want
    del full

    def one_step():
        nonlocal state
        state, _ = step(state, placed[-1])

    _, wall = timed(one_step, dev)
    events = profiled_events(one_step, dev, cpu=False)
    out["busy"] = busy_of(event_seconds(events), wall)
    out["kernels"] = kernel_seconds_by_name(events)
    return out


def run_sharded(cat, queries, dev, power: str) -> dict:
    """Phase 17: the sharded train step, ``make_train_step`` on parameters
    and a batch placed by the sharding rules, one NCCL rank per card,
    spawned, against the plain step from the same seed."""
    from repro_torch.data import JoinCorpus, TokenBatcher
    t0 = time.perf_counter()
    cfgs = sp_configs()
    cfg = cfgs["cfg"]
    shutil.rmtree(SP_DIR, ignore_errors=True)
    SP_DIR.mkdir(parents=True)
    corpus = JoinCorpus.build(cat, queries["lastfm_A1"], vocab=256,
                              device=dev)
    batcher = TokenBatcher(JoinCorpus(corpus.gfjs, cfg.vocab,
                                      corpus.tokens_per_row), *SP_BATCH,
                           device=dev)
    torch.save([{k: v.cpu() for k, v in batcher.next_batch().items()}
                for _ in range(SP_STEPS)], SP_DIR / "batches.pt")
    del corpus, batcher
    gc.collect()
    torch.cuda.empty_cache()

    world = torch.cuda.device_count()
    print(f"  world {world}: one NCCL rank per card, mesh "
          f"make_local_mesh(model={world})")
    a = sp_spawn(dict(backend="nccl", device=dev.type, world=world,
                      init=f"tcp://localhost:{free_port()}", cfg=cfg,
                      opt=SP_OPT))[0]
    shutil.rmtree(SP_DIR, ignore_errors=True)
    check(a["sharded"] > 0, "the rules sharded no parameter")
    if world == 1:
        check(a["bit_equal"] or a["rel_l2"] <= TRAIN_TOL,
              f"the placed step's parameters are {a['rel_l2']:.3g} (L2) "
              f"from the plain step's (> {TRAIN_TOL}): {a['unequal'][:4]}")
        check(not a["bit_equal"] or a["losses"] == a["plain_losses"],
              f"losses {a['losses']} vs the plain {a['plain_losses']}")
    else:
        gap = max(abs(x - y) for x, y in zip(a["losses"],
                                              a["plain_losses"]))
        check(gap < SP_LOSS_GAP, f"the placed step's losses {a['losses']} "
              f"vs the one-card step's {a['plain_losses']}")
    check(all(np.isfinite(a["losses"] + a["norms"])),
          f"a loss or grad norm is not finite: {a['losses']}")
    print(f"  {cfg.name}: {cfg.num_layers} of {cfgs['depth']} layers, "
          f"{a['params']} parameters (bf16), {SP_STEPS} steps of "
          f"{SP_BATCH[0]} x {SP_BATCH[1]} join-fed tokens, AdamW lr "
          f"{TRAIN_LR}, deterministic mode, mesh {a['mesh']} "
          f"({a['sharded']} parameters sharded by arch_rules): placed "
          f"parameters "
          + ("bit-equal to make_train_step's" if a["bit_equal"]
             else f"{a['rel_l2']:.3g} (L2) from make_train_step's, "
             f"unequal: {a['unequal']}")
          + f"; losses {a['losses']} (plain {a.get('plain_losses')})")
    print(f"  ms a step (no gate): plain {ms_list(a['plain_s'])}, placed "
          f"{ms_list(a['placed_s'])} (placement {a['place_s'] * 1e3:.1f} "
          f"ms); one more placed step {fmt_busy(a['busy'])}; peak device "
          f"bytes plain {a.get('plain_peak')}, placed {a['peak']} "
          f"[{power}]")
    print("      card time by kernel over that step (s): " + ", ".join(
        f"{k} {v[0]:.6f} x{v[1]}" for k, v in a["kernels"].items()))
    out = dict(a, world=world, power=power,
               seconds=time.perf_counter() - t0)
    print(f"  phase {out['seconds']:.1f}s [{power}]")
    return out


# -- phase 18: every cell placed, and the dry run -----------------------------

PC_SEED = 18
PC_TRAIN_ARCH = "granite_moe_1b_a400m"       # (a): phase 13's full model
PC_TRAIN_BATCH = TRAIN_FULL[PC_TRAIN_ARCH][1:]   # 8 x 1,024 join-fed tokens
PC_TRAIN_STEPS = 3
PC_REC_STEPS = 2
# (b): 32 x 512, the most rows (by powers of two) that keep (b) under
# 30 s on the H100 (24.4-26.9 s on an H100 80GB HBM3 at 700 W; 64 x 512
# ran past 30 s): the sLSTM loop over 512 positions costs launches more
# than rows; 1,024 positions would double the loop
PC_REC_BATCH = (32, 512)
PC_SERVE_ARCHS = ("qwen3_8b", "granite_moe_1b_a400m")
PC_SERVE = (4, 3072)                 # (c): requests x prompt tokens
PC_NEW = 16                          # (c): greedy tokens a request
PC_LOGIT_TOL = LM_WIDTH_TOL          # (c) if not bit-equal: x max|logits|
# (d): the dry run's FLOPs against train_bounds' operations, once the
# bound's count is moved to what the port runs (``pc_expected_flops``):
# the whole S x S score square of each attention where the bound counts
# the causal half (every block is computed, forward, backward and
# recompute); remat's recompute of the blocks (``remat_ops``), the MoE
# router's included, but not the dense MLP's down projection, which
# torch.utils.checkpoint's non-reentrant recompute skips (nothing after
# it saves its output: the recompute stops at the last tensor the
# backward needs; the MoE combine saves the experts' outputs, so they
# are recomputed); and the MoE capacity's padded slots
# (``capacity_factor``).  Then the two are the same count (a CPU dry run
# of both cells agrees to the FLOP); the tolerance is float64 rounding of
# the padded slots' share.
PC_FLOPS_TOL = 1e-9


def pc_configs() -> dict:
    """Phase 18's configurations: (a) granite-moe at full size; (b)
    zamba2 and xLSTM at phase 14's full width and reduced depth, float32;
    (c) Qwen3-8B at full size and granite-moe at full size, bf16; (d)
    phase 17's Qwen3-8B cell and (a)'s."""
    from repro_torch.configs import get_config
    train, rec = train_configs(), recurrent_configs()
    return dict(a=train["full"][PC_TRAIN_ARCH],
                b={a: rec[a]["width"] for a in REC_ARCHS},
                c={a: get_config(a) for a in PC_SERVE_ARCHS},
                d={SP_ARCH: (sp_configs()["cfg"], SP_BATCH),
                   PC_TRAIN_ARCH: (train["full"][PC_TRAIN_ARCH],
                                   PC_TRAIN_BATCH)})


def pc_batches(corpus, cfg, B: int, S: int, n: int, dev) -> list:
    from repro_torch.data import JoinCorpus, TokenBatcher
    batcher = TokenBatcher(JoinCorpus(corpus.gfjs, cfg.vocab,
                                      corpus.tokens_per_row), B, S,
                           device=dev)
    return [batcher.next_batch() for _ in range(n)]


def pc_train(cfg, batches, dev, mesh, *, profiled: bool) -> dict:
    """In deterministic mode: the plain ``make_train_step`` over
    ``batches``, the parameters copied to the host, the model freed and
    rebuilt from the same seed, placed on ``mesh`` by ``arch_rules``
    (``specs.place_cell``, as the dry run places its cells) and stepped
    over the same batches placed; with ``profiled`` one more placed step
    under the profiler."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import dryrun, specs
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    B, S = batches[0]["tokens"].shape
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1)

    def build():
        return LM(cfg, device=dev,
                  generator=torch.Generator(dev).manual_seed(PC_SEED))

    out: dict = dict(batch=B, seq=S, layers=cfg.num_layers)
    with deterministic_mode():
        reset_peak(dev)
        lm = build()
        state, (out["plain_losses"], _), out["plain_s"] = dp_steps(
            make_train_step(lm, ocfg), init_train_state(lm), batches, dev)
        out["plain_peak"] = peak_bytes(dev)
        want = {n: p.detach().cpu() for n, p in state.params.items()}
        del lm, state
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak(dev)
        lm = build()
        sh = specs.cell_shardings(lm, "train", mesh, B, S,
                                  specs.arch_rules(cfg, mesh))
        (step, (state, _)), out["place_s"] = timed(
            lambda: specs.place_cell(lm, "train", (None, batches[0]), sh,
                                     seq=S, opt_cfg=ocfg), dev)
        placed = [{k: distribute_tensor(v, mesh, sh[1][k].placements)
                   for k, v in b.items()} for b in batches]
        out["argument_bytes"] = dryrun.local_bytes((state, placed[0]))
        out["sharded"] = sum(any(not p.is_replicate() for p in t.placements)
                             for t in lm.parameters())
        state, (out["losses"], norms), out["placed_s"] = dp_steps(
            step, state, placed, dev)
        out["peak"] = peak_bytes(dev)
        full = {n: p.full_tensor() for n, p in state.params.items()}
    same = {n: torch.equal(f.cpu(), want[n]) for n, f in full.items()}
    out["bit_equal"] = all(same.values()) and \
        out["losses"] == out["plain_losses"]
    out["unequal"] = sorted(n for n, ok in same.items() if not ok)
    out["bound"] = train_bounds(lm, B, S)
    check(all(np.isfinite(out["losses"] + norms)),
          f"{cfg.name}: a placed loss or grad norm is not finite")
    del want, full
    if profiled:
        def one_step():
            nonlocal state
            state, _ = step(state, placed[-1])

        _, wall = timed(one_step, dev)
        events = profiled_events(one_step, dev, cpu=False)
        out["busy"] = busy_of(event_seconds(events), wall)
    del lm, state, placed, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pc_greedy(lm, tokens, s_max: int, new: int, dev) -> tuple:
    """Greedy prefill + ``new - 1`` decode steps on the LM's own API (as
    ``ServeEngine`` drives it), placed or plain: (tokens [B, new], each
    step's last-position logits [new, B, V] on the card, prefill s,
    decode s a step)."""
    from repro_torch.dist.act_sharding import is_dtensor

    def full(t):
        return t.full_tensor() if is_dtensor(t) else t

    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        logits, caches = lm.prefill(tokens, s_max)
        last = [full(logits[:, -1])]
        tok = logits[:, -1].argmax(-1, keepdim=True)
        sync(dev)
        t1 = time.perf_counter()
        toks = [full(tok)]
        for _ in range(new - 1):
            logits, caches = lm.decode_step(tok, caches)
            last.append(full(logits[:, -1]))
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(full(tok))
        sync(dev)
        t2 = time.perf_counter()
    placed = all(is_dtensor(t) for t in _cache_leaves(caches))
    return (torch.cat(toks, 1).cpu().numpy(), torch.stack(last),
            t1 - t0, (t2 - t1) / (new - 1), placed)


def _cache_leaves(caches) -> list:
    from repro_torch.launch.specs import map_caches
    leaves: list = []
    map_caches(lambda t, k: leaves.append(t), caches)
    return leaves


def pc_serve(cfg, tokens, dev, mesh) -> dict:
    """(c) one model from one seed, plain and then placed on ``mesh``
    (its parameters by ``arch_rules``, its caches by ``cache_shardings``
    as ``place_params`` arranges): greedy tokens, logits, times."""
    from repro_torch.launch import specs
    from repro_torch.models.model import LM
    B, S = tokens.shape
    s_max = S + PC_NEW

    def build():
        return LM(cfg, device=dev,
                  generator=torch.Generator(dev).manual_seed(PC_SEED))

    lm = build()
    toks, want, pre, dec, _ = pc_greedy(lm, tokens, s_max, PC_NEW, dev)
    bound = lm_bounds(lm, B, S, PC_NEW)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    lm = build()
    sh = specs.cell_shardings(lm, "prefill", mesh, B, s_max,
                              specs.arch_rules(cfg, mesh))
    _, (_, placed_b) = specs.place_cell(lm, "prefill", (None, {
        "tokens": tokens}), sh, seq=s_max)
    ptoks, got, ppre, pdec, caches_placed = pc_greedy(
        lm, placed_b["tokens"], s_max, PC_NEW, dev)
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    out = dict(tokens_equal=bool(np.array_equal(toks, ptoks)),
               bit_equal=bool(torch.equal(got, want)), rel_err=err,
               caches_placed=caches_placed, prefill_s=pre,
               decode_s=dec, placed_prefill_s=ppre, placed_decode_s=pdec,
               bound=bound, batch=B, seq=S)
    del lm, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pc_dry(cfg, B: int, S: int) -> dict:
    """(d) one train cell of ``cfg`` through the dry run's machinery
    (``dryrun.measure``: a fake world of one rank, the (1, 1) mesh, meta
    tensors, the op counter): its result and roofline terms."""
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_local_mesh
    with dryrun.fake_world(1):
        mesh = make_local_mesh(model=1, device="cpu")
        res, _ = dryrun.measure(cfg, "train", B, S, mesh)
    res["terms"] = dict(compute=res["flops"] / roofline.PEAK_FLOPS,
                        memory=res["bytes_accessed"] / roofline.HBM_BW,
                        collective=res["collectives"]["total"]
                        / roofline.LINK_BW)
    return res


def pc_expected_flops(cfg, bound: dict, B: int, S: int) -> float:
    """train_bounds' operations moved to what the port runs (PC_FLOPS_TOL's
    list)."""
    from repro_torch.models.moe import capacity
    H, hd, L, d, T = (cfg.num_heads, cfg.head_dim_, cfg.num_layers,
                      cfg.d_model, B * S)
    remat = cfg.remat != "none"
    causal = 4 * H * hd * (S * (S + 1) // 2) * B * L     # the bound's
    square = 4 * H * hd * S * S * B * L                  # the port's
    # forward, backward (twice the forward) and, with remat, the recompute
    out = (bound["ops"] - 3 * causal + (4 if remat else 3) * square
           + bound["f32_ops"])
    m = cfg.moe
    moe_layers = 0 if m is None else L - m.first_dense_layers
    if remat:
        out += bound["remat_ops"] - causal
        out -= 2 * d * cfg.d_ff * T * (L - moe_layers)   # dense down proj
        if m is not None:                                 # the router
            out += 2 * d * m.num_experts * T * moe_layers
    if m is not None:
        expert = 3 * d * m.d_ff_expert * m.experts_per_token \
            * moe_layers * T
        rows = capacity(T, m.experts_per_token, m.num_experts,
                        m.capacity_factor) * m.num_experts
        per_slot = (6 + (2 if remat else 0)) * expert
        out += per_slot * (rows / (T * m.experts_per_token) - 1)
    return float(out)


def run_placed_cells(cat, queries, sharded: dict, dev, power: str) -> dict:
    """Phase 18: every family's cells on DTensor placements on the card,
    at world 1 on the (1, 1) mesh, against the plain path from the same
    seed, and the dry run of the card's own cells."""
    import datetime
    import torch.distributed as dist
    from repro_torch.data import JoinCorpus
    from repro_torch.launch.mesh import make_local_mesh
    t0 = time.perf_counter()
    cfgs = pc_configs()
    corpus = JoinCorpus.build(cat, queries["lastfm_A1"], vocab=256,
                              device=dev)
    out: dict = dict(power=power)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DP_COLLECTIVE_S))
    try:
        mesh = make_local_mesh(model=1, device=dev.type)
        # (a) granite-moe at full size
        cfg = cfgs["a"]
        t = time.perf_counter()
        a = pc_train(cfg, pc_batches(corpus, cfg, *PC_TRAIN_BATCH,
                                     PC_TRAIN_STEPS, dev), dev, mesh,
                     profiled=True)
        a["seconds"] = time.perf_counter() - t
        check(a["sharded"] > 0 or mesh.size() == 1,
              "(a) the rules sharded no parameter")
        check(a["bit_equal"], f"(a) {cfg.name}: placed steps differ from "
              f"the plain steps: losses {a['losses']} vs "
              f"{a['plain_losses']}, unequal {a['unequal'][:4]}")
        b = a["bound"]
        print(f"  (a) {cfg.name}: {cfg.num_layers} layers, "
              f"{b['params']} parameters (bf16), {PC_TRAIN_STEPS} steps of "
              f"{a['batch']} x {a['seq']} join-fed tokens, deterministic "
              f"mode, mesh {tuple(mesh.shape)} by arch_rules "
              f"(specs.place_cell): parameters and losses bit-equal to "
              f"make_train_step's ({a['losses']}); ms a step plain "
              f"{ms_list(a['plain_s'])}, placed {ms_list(a['placed_s'])} "
              f"(bound {b['step_s'] * 1e3:.3f} ms, {b['bound_by']}); "
              f"placement {a['place_s'] * 1e3:.1f} ms; one more placed "
              f"step {fmt_busy(a['busy'])}; peak device bytes plain "
              f"{a['plain_peak']}, placed {a['peak']} "
              f"({a['seconds']:.1f}s) [{power}]")
        out["a"] = a
        # (b) zamba2 and xLSTM at phase 14's depths
        out["b"] = {}
        t = time.perf_counter()
        for arch, cfg in cfgs["b"].items():
            r = pc_train(cfg, pc_batches(corpus, cfg, *PC_REC_BATCH,
                                         PC_REC_STEPS, dev), dev, mesh,
                         profiled=False)
            check(r["bit_equal"], f"(b) {cfg.name}: placed steps differ "
                  f"from the plain steps: {r['losses']} vs "
                  f"{r['plain_losses']}, unequal {r['unequal'][:4]}")
            print(f"  (b) {cfg.name} float32, {cfg.num_layers} layers, "
                  f"{PC_REC_STEPS} steps of {r['batch']} x {r['seq']}: "
                  f"placed parameters and losses bit-equal to plain "
                  f"({r['losses']}); ms a step plain "
                  f"{ms_list(r['plain_s'])}, placed "
                  f"{ms_list(r['placed_s'])} (bound "
                  f"{r['bound']['step_s'] * 1e3:.3f} ms)")
            out["b"][arch] = r
        out["b_seconds"] = time.perf_counter() - t
        print(f"  (b) {out['b_seconds']:.1f}s at {PC_REC_BATCH[0]} x "
              f"{PC_REC_BATCH[1]}")
        # (c) serving on placed parameters and caches
        out["c"] = {}
        for arch, cfg in cfgs["c"].items():
            t = time.perf_counter()
            tokens = pc_batches(corpus, cfg, *PC_SERVE, 1, dev)[0]["tokens"]
            r = pc_serve(cfg, tokens, dev, mesh)
            r["seconds"] = time.perf_counter() - t
            check(r["tokens_equal"], f"(c) {cfg.name}: placed greedy tokens "
                  f"differ from the plain run's")
            check(r["caches_placed"], f"(c) {cfg.name}: a cache is plain")
            check(r["bit_equal"] or r["rel_err"] <= PC_LOGIT_TOL,
                  f"(c) {cfg.name}: logits {r['rel_err']:.3g} x max|logits| "
                  f"from plain (> {PC_LOGIT_TOL})")
            bd = r["bound"]
            print(f"  (c) {cfg.name} bf16, {cfg.num_layers} layers: "
                  f"{r['batch']} x {r['seq']} join-fed prefill and "
                  f"{PC_NEW} greedy tokens on placed parameters and placed "
                  f"caches: tokens equal to plain, logits "
                  + ("bit-equal" if r["bit_equal"] else
                     f"{r['rel_err']:.3g} x max|logits| from plain")
                  + f"; prefill {r['placed_prefill_s']:.4f} s (plain "
                  f"{r['prefill_s']:.4f}, bound {bd['prefill_s']:.4f}), "
                  f"decode {r['placed_decode_s'] * 1e3:.3f} ms a step "
                  f"(plain {r['decode_s'] * 1e3:.3f}, bound "
                  f"{bd['decode_step_s'] * 1e3:.3f}) "
                  f"({r['seconds']:.1f}s) [{power}]")
            out["c"][arch] = r
    finally:
        dist.destroy_process_group()
    del corpus
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the dry run of the card's own cells, on meta
    out["d"] = {}
    measured = {SP_ARCH: (sharded.get("placed_s"),
                          sharded.get("argument_bytes")),
                PC_TRAIN_ARCH: (out["a"]["placed_s"],
                                out["a"]["argument_bytes"])}
    for arch, (cfg, (B, S)) in cfgs["d"].items():
        t = time.perf_counter()
        r = pc_dry(cfg, B, S)
        r["seconds"] = time.perf_counter() - t
        from repro_torch.models.model import LM
        bound = train_bounds(LM(cfg, device="meta"), B, S)
        want = pc_expected_flops(cfg, bound, B, S)
        r["expected_flops"] = want
        r["bound_ops"] = bound["ops"] + bound["f32_ops"]
        gap = r["flops"] / want - 1
        check(abs(gap) <= PC_FLOPS_TOL,
              f"(d) {cfg.name}: the dry run's {r['flops']:.6g} FLOPs are "
              f"{gap:+.3g} from the bound's count moved to what the port "
              f"runs ({want:.6g})")
        step_s, arg_bytes = measured[arch]
        if arg_bytes is not None:
            check(r["memory"]["argument_size_in_bytes"] == arg_bytes,
                  f"(d) {cfg.name}: the dry run's argument bytes "
                  f"{r['memory']['argument_size_in_bytes']} are not the "
                  f"card's parameter, state and batch bytes {arg_bytes}")
        ms = "not measured" if not step_s else \
            f"{float(np.median(step_s[1:] or step_s)) * 1e3:.3f} ms"
        terms = r["terms"]
        print(f"  (d) {cfg.name} ({cfg.num_layers} layers, {B} x {S}) on "
              f"meta, mesh (1, 1), {r['seconds']:.1f}s: FLOPs "
              f"{r['flops']:.6g} (train_bounds' operations "
              f"{r['bound_ops']:.6g}; moved to the whole score square, "
              f"remat's recompute and the MoE padding {want:.6g}: "
              f"{gap:+.3g}); argument "
              f"bytes {r['memory']['argument_size_in_bytes']} (the card's "
              f"parameters, state and batch: {arg_bytes}); roofline at "
              f"H100 peaks: compute {terms['compute'] * 1e3:.3f} ms, "
              f"memory {terms['memory'] * 1e3:.3f} ms (eager bytes "
              f"{r['bytes_accessed']:.6g}), collective "
              f"{terms['collective'] * 1e3:.3f} ms; the card's placed "
              f"step: {ms} [{power}]")
        out["d"][arch] = r
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.1f}s [{power}]")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the per-shape measurements "
                        "(JSON) to this file")
    args = parser.parse_args()
    # phase 13's deterministic runs: cuBLAS reads it at its first call
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: the port's kernels run on the card",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"FAIL: the repository's src/repro_torch is missing: {exc}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    power = device_line()
    print(power)
    build_kernels()
    kernels = smoke(dev, LASTFM_2K, args.out, dict(device=kind, power=power))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


def smoke(dev, lastfm_kw, out_path, header) -> list:
    """Phases 3-18 on ``dev``; returns the kernels line's entries.  (The
    measurements need the card; a CPU rehearsal at a small ``lastfm_kw``
    replaces ``cuda_ms`` and ``device_seconds``.)"""
    from repro_torch.kernels.dense_message import dense_message
    from repro_torch.kernels.expand_gather import expand_gather
    from repro_torch.kernels.expand_many import expand_many
    from repro_torch.kernels.mul_segsum import mul_segsum
    from repro_torch.kernels.run_boundaries import run_boundaries
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import Tracer
    from repro_torch.relational.synth import lastfm_like

    err = check_edge_cases(dev)
    seg_err, b_err = check_summary_kernel_cases(dev)
    g_err, d_err = check_message_kernel_cases(dev)

    t0 = time.perf_counter()
    cat, queries = lastfm_like(**lastfm_kw)
    print(f"data: lastfm_like{lastfm_kw} in {time.perf_counter() - t0:.3f}s: "
          f"user_artists {cat['user_artists'].num_rows} rows, user_friends "
          f"{cat['user_friends'].num_rows} rows")
    fallbacks = REGISTRY.counter("engine.numpy_fallbacks")
    tr_a1, tr_a2 = Tracer(), Tracer()
    expand_many.launches = 0
    fb0 = fallbacks.value
    a1 = run_a1(cat, queries["lastfm_A1"], dev, tr_a1)
    a2 = run_a2(cat, queries["lastfm_A2"], dev, tr_a2)
    launches = expand_many.launches
    check(launches > 0, "the main path launched no expand_many kernel")
    check(fallbacks.value == fb0, "numpy fallbacks on the main path")
    shapes_a1 = kernel_shapes(tr_a1, "lastfm_A1")
    shapes_a2 = kernel_shapes(tr_a2, "lastfm_A2")
    print(f"main path: expand_many launches={launches} (lastfm_A1 "
          f"{len(shapes_a1)}, lastfm_A2 {len(shapes_a2)}), numpy fallbacks=0")

    mul_segsum.launches = run_boundaries.launches = 0
    fb1 = fallbacks.value
    tracers: list = []
    answers: dict = {}
    summary = run_summary(cat, queries, a1, a2, dev, tracers, answers)
    summary_launches = {"mul_segsum": mul_segsum.launches,
                        "run_boundaries": run_boundaries.launches}
    for name, n in summary_launches.items():
        check(n > 0, f"the summary path launched no {name} kernel")
    check(fallbacks.value == fb1, "numpy fallbacks on the summary path")
    print(f"summary path: launches {summary_launches}, numpy fallbacks=0")
    del a2["gfjs"]

    expand_gather.launches = dense_message.launches = 0
    dense_message.thin_launches = 0
    fb2 = fallbacks.value
    msg_tracers: list = []
    dense = run_dense_and_api(cat, queries, a1, a2, dev, msg_tracers)
    message_launches = {"expand_gather": expand_gather.launches,
                        "dense_message": dense_message.launches}
    thin_launches = dense_message.thin_launches
    for name, n in message_launches.items():
        check(n > 0, f"the dense message path launched no {name} kernel")
    check(thin_launches == message_launches["dense_message"],
          f"{thin_launches} of the path's {dense_message.launches} "
          f"dense_message launches took the thin kernel")
    check(fallbacks.value == fb2, "numpy fallbacks on the dense message path")
    print(f"dense message path: launches {message_launches} (dense_message: "
          f"{thin_launches} thin), numpy fallbacks=0")
    phi12, m_ua = dense.pop("_split_args")
    dense_split(phi12, "U2", m_ua, dev)            # warm
    dense["split"] = dense_split(phi12, "U2", m_ua, dev)
    print("  one A1 message, steps s: " + ", ".join(
        f"{k} {v:.6f}" for k, v in dense["split"].items()))

    # lastfm_A1's launches for one run() and one desummarize() (the
    # smoke desummarizes twice), plus lastfm_A2's widest generation launch
    seen = set()
    one_run = []
    for sh in shapes_a1:
        key = (sh["phase"], sh["k"], sh["runs"], sh["total"])
        if key not in seen:
            seen.add(key)
            one_run.append(sh)
    widest = max((s for s in shapes_a2 if s["phase"] == "generate"),
                 key=lambda s: s["k"] * s["total"])
    torch.cuda.empty_cache()
    print("expand_many at the main path's shapes (CUDA events):")
    rows = [measure_shape(s, a1["gfjs"], dev, i)
            for i, s in enumerate(one_run)]
    torch.cuda.empty_cache()
    rows.append(measure_shape(widest, None, dev, len(rows)))
    a1_rows = [r for r in rows if r["query"] == "lastfm_A1"]
    total = {key: sum(r[key] for r in a1_rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"  one lastfm_A1 run's {len(a1_rows)} launches: kernel "
          f"{total['ms']:.4f}ms, bound {total['bound_ms']:.4f}ms, plain "
          f"{total['plain_ms']:.4f}ms, repeat_interleave "
          f"{total['library_ms']:.4f}ms"
          f"{beside(PREVIOUS_MS[('expand_many', 'lastfm_A1')])}")
    err = max([err] + [r["max_abs_err"] for r in rows])

    shapes = summary_shapes(tracers)
    torch.cuda.empty_cache()
    print("mul_segsum and run_boundaries at the summary path's shapes "
          "(CUDA events; seeded inputs):")
    summary_rows = [measure_summary_shape(key, n, dev, i)
                    for i, (key, n) in enumerate(sorted(
                        shapes.items(), key=lambda kv: kv[0][:2]))]

    mshapes = message_shapes(msg_tracers)
    rates = message_rates(dev)
    print(f"expand_gather and dense_message at phase 7's shapes and the "
          f"reference benchmark's (CUDA events; int32 multiply-adds at "
          f"{rates['imad_per_s']:.6g}/s over {rates['instr_per_mac']} "
          f"instruction(s) each, FP32 at {FP32_FLOP_PER_S:.3g} FLOP/s, HBM "
          f"at {HBM_BYTES_PER_S:.3g} B/s):")
    torch.cuda.empty_cache()
    message_rows = []
    for i, (key, n) in enumerate(sorted(mshapes.items())):
        if key[0] == "dense_message":
            message_rows.append(measure_dense_shape(
                *key[1:], n, dev, i, rates, cold=True))
        else:
            runs = key[1]
            level = next(lv for lv in a1["gfjs"].levels
                         if lv.num_runs == runs and "A2" in lv.vars)
            message_rows.append(measure_gather_shape(runs, n, dev, i,
                                                     level))
    for j, dtype in enumerate(("float32", "int32")):
        message_rows.append(measure_dense_shape(2048, 2048, 128, dtype, 0,
                                                dev, 100 + j, rates))
    message_rows.append(measure_gather_shape(1_000_000, 0, dev, 102))
    print("dense_message K sweep at [1892, 1892] @ [1892, K] counts, thin "
          "kernel against tiled:")
    k_sweep = dense_k_sweep(dev, 103)

    # the serving phase builds its own; phase 10 desummarizes lastfm_A1
    # again from its levels (its device memo goes now)
    mono_a1 = memo_free_copy(a1.pop("gfjs"))
    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb3 = fallbacks.value
    service = run_service(lastfm_kw, dev)
    service["launches"] = {"expand_many": expand_many.launches,
                           "mul_segsum": mul_segsum.launches,
                           "run_boundaries": run_boundaries.launches}
    for name, n in service["launches"].items():
        check(n > 0, f"the serving path launched no {name} kernel")
    check(fallbacks.value == fb3, "numpy fallbacks on the serving path")
    print(f"serving path: launches {service['launches']}, numpy "
          f"fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb4 = fallbacks.value
    print("partitioned builds:")
    partitioned = run_partitioned(cat, queries, mono_a1, a2, answers, dev)
    partitioned["launches"] = {"expand_many": expand_many.launches,
                               "mul_segsum": mul_segsum.launches,
                               "run_boundaries": run_boundaries.launches}
    for name, n in partitioned["launches"].items():
        check(n > 0, f"the partitioned path launched no {name} kernel")
    check(fallbacks.value == fb4, "numpy fallbacks on the partitioned path")
    print(f"partitioned path: launches {partitioned['launches']}, numpy "
          f"fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb5 = fallbacks.value
    print("the LM serving path:")
    lm = run_lm_serving(cat, queries, dev)
    lm["launches"] = {"expand_many": expand_many.launches,
                      "mul_segsum": mul_segsum.launches,
                      "run_boundaries": run_boundaries.launches}
    for name, n in lm["launches"].items():
        check(n > 0, f"the LM serving path launched no {name} kernel")
    check(fallbacks.value == fb5, "numpy fallbacks on the LM serving path")
    print(f"LM serving path: launches {lm['launches']}, numpy fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb6 = fallbacks.value
    print("the moe serving path:")
    moe = run_moe_serving(cat, queries, dev)
    moe["launches"] = {"expand_many": expand_many.launches,
                       "mul_segsum": mul_segsum.launches,
                       "run_boundaries": run_boundaries.launches}
    for name, n in moe["launches"].items():
        check(n > 0, f"the moe serving path launched no {name} kernel")
    check(fallbacks.value == fb6, "numpy fallbacks on the moe serving path")
    print(f"moe serving path: launches {moe['launches']}, numpy "
          f"fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = 0
    fb7 = fallbacks.value
    print("training on the card:")
    training = run_training(cat, queries, dev, header["power"])
    training["launches"] = {"expand_many": expand_many.launches}
    check(training["launches"]["expand_many"] > 0,
          "the training path launched no expand_many kernel")
    check(fallbacks.value == fb7, "numpy fallbacks on the training path")
    print(f"training path: launches {training['launches']}, numpy "
          f"fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb8 = fallbacks.value
    print("the recurrent families on the card:")
    recurrent = run_recurrent(cat, queries, dev, header["power"])
    recurrent["launches"] = {"expand_many": expand_many.launches,
                             "mul_segsum": mul_segsum.launches,
                             "run_boundaries": run_boundaries.launches}
    for name, n in recurrent["launches"].items():
        check(n > 0, f"the recurrent serving path launched no {name} "
              f"kernel")
    check(fallbacks.value == fb8,
          "numpy fallbacks on the recurrent serving path")
    print(f"recurrent serving path: launches {recurrent['launches']}, numpy "
          f"fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb9 = fallbacks.value
    print("the vlm and audio families on the card:")
    media = run_media(cat, queries, dev, header["power"])
    media["launches"] = {"expand_many": expand_many.launches,
                         "mul_segsum": mul_segsum.launches,
                         "run_boundaries": run_boundaries.launches}
    for name, n in media["launches"].items():
        check(n > 0, f"the vlm and audio serving path launched no {name} "
              f"kernel")
    check(fallbacks.value == fb9,
          "numpy fallbacks on the vlm and audio serving path")
    print(f"vlm and audio serving path: launches {media['launches']}, "
          f"numpy fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb10 = fallbacks.value
    print("data parallelism across ranks:")
    data_parallel = run_data_parallel(cat, queries, mono_a1, dev,
                                      header["power"])
    data_parallel["launches"] = {"expand_many": expand_many.launches,
                                 "mul_segsum": mul_segsum.launches,
                                 "run_boundaries": run_boundaries.launches}
    check(data_parallel["launches"]["expand_many"] > 0,
          "the data-parallel path launched no expand_many kernel")
    check(fallbacks.value == fb10,
          "numpy fallbacks on the data-parallel path")
    print(f"data-parallel path: launches {data_parallel['launches']}, "
          f"numpy fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb11 = fallbacks.value
    print("the sharded train step (DTensor placements):")
    sharded = run_sharded(cat, queries, dev, header["power"])
    sharded["launches"] = {"expand_many": expand_many.launches,
                           "mul_segsum": mul_segsum.launches,
                           "run_boundaries": run_boundaries.launches}
    check(sharded["launches"]["expand_many"] > 0,
          "the sharded path launched no expand_many kernel")
    check(fallbacks.value == fb11, "numpy fallbacks on the sharded path")
    print(f"sharded path: launches {sharded['launches']}, numpy "
          f"fallbacks=0")

    gc.collect()
    torch.cuda.empty_cache()
    expand_many.launches = mul_segsum.launches = 0
    run_boundaries.launches = 0
    fb12 = fallbacks.value
    print("every family's cells placed, and the dry run:")
    placed_cells = run_placed_cells(cat, queries, sharded, dev,
                                    header["power"])
    placed_cells["launches"] = {"expand_many": expand_many.launches,
                                "mul_segsum": mul_segsum.launches,
                                "run_boundaries": run_boundaries.launches}
    check(placed_cells["launches"]["expand_many"] > 0,
          "the placed cells' path launched no expand_many kernel")
    check(fallbacks.value == fb12,
          "numpy fallbacks on the placed cells' path")
    print(f"placed cells' path: launches {placed_cells['launches']}, numpy "
          f"fallbacks=0")

    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(dict(
            header, shapes=rows,
            summary_shapes=summary_rows, summary=summary,
            lastfm_A1={k: v for k, v in a1.items() if k != "gfjs"},
            lastfm_A2=a2, launches=launches,
            summary_launches=summary_launches, dense=dense,
            message_shapes=message_rows, message_launches=message_launches,
            thin_launches=thin_launches, k_sweep=k_sweep, rates=rates,
            service=service, partitioned=partitioned, lm_serving=lm,
            moe_serving=moe, training=training, recurrent=recurrent,
            media=media, data_parallel=data_parallel, sharded=sharded,
            placed_cells=placed_cells,
            previous_ms={"/".join(map(str, k)): v
                         for k, v in PREVIOUS_MS.items()}), indent=1))
    kernels = [dict(
        name="expand_many", route="cuda",
        source="src/repro_torch/kernels/csrc/expand_many.cu",
        replaces="src/repro/kernels/expand_fused.py:39",
        launches=launches, max_abs_err=err,
        ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"], bound_by="bytes",
        library_ms=total["library_ms"]),
        kernel_row("mul_segsum", summary_rows,
                   summary_launches["mul_segsum"], seg_err,
                   "src/repro_torch/kernels/csrc/mul_segsum.cu",
                   "src/repro/kernels/segsum.py:29"),
        kernel_row("run_boundaries", summary_rows,
                   summary_launches["run_boundaries"], b_err,
                   "src/repro_torch/kernels/csrc/run_boundaries.cu",
                   "src/repro/kernels/boundaries.py:26"),
        kernel_row("expand_gather", message_rows,
                   message_launches["expand_gather"], g_err,
                   "src/repro_torch/kernels/csrc/expand_many.cu",
                   "src/repro/kernels/expand.py:44"),
        kernel_row("dense_message", message_rows,
                   message_launches["dense_message"], d_err,
                   "src/repro_torch/kernels/csrc/dense_message.cu",
                   "src/repro/kernels/dense_contract.py:29")]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
