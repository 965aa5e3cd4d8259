"""The port's op counter and roofline against the reference's HLO analysis,
and the dry run's multi-pod and ``sp_fsdp`` cells, on the CPU.

* ``launch/op_analysis.py``'s counter mirrors ``tests/test_roofline.py``'s
  five tests of ``analyze_hlo``: a loop of 8 products of 256^2 counts
  2*256^3*8 FLOPs, a nested loop of 3 x 4 counts 2*128^3*12, a batched
  einsum 2*4*64*32*16, bytes grow by 8 MB per iteration of a 1,024^2
  elementwise loop (one op a step: eager runs each op as a pass over
  memory, as XLA's fused body does once), and the per-op records carry
  the kinds that ran.  On meta tensors it counts what the same model
  counts on real ones (the loops that run one step for many:
  ``layers.uniform_loop``).
* On a fake (4, 2) world a matrix product whose columns are sharded over
  both mesh dims counts 1/8 of the global FLOPs per device, and its
  gather back counts the operand bytes a hand count gives.
* ``roofline.model_flops`` equals the reference's for every arch x
  applicable shape; ``roofline.analyze`` gives the reference's terms once
  each side's peaks are divided out.
* The matrix-product FLOPs of each family's single-device smoke train
  and prefill cells equal the reference's ``analyze_hlo`` of the same
  cell compiled, with remat off (the reference's ``jax.checkpoint`` of a
  scanned unit and the port's per-block checkpoints recompute different
  amounts, zamba2's most); exactly, except where XLA rewrites a product
  the port runs as one (``HLO_TOL``).
* One architecture per family runs on the (2, 16, 16) mesh of a fake
  world of 512 ranks, and under ``--preset sp_fsdp`` (``SP_FSDP_RULES``
  with the sequence-parallel activation constraint) on 16 x 16, with
  per-device argument bytes equal to the reference's shard shapes and a
  roofline of finite terms.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as ref_get_smoke
from repro.launch import roofline as ref_roofline
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model import LM as RefLM
from repro.train import optim as ref_optim
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_smoke
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import flash
from repro_torch.models.model import LM
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

from torch_dryrun_ref import reference_argument_bytes, unit
import torch_threads  # noqa: F401

CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(a)]


def flops_of(fn, *args) -> float:
    with OpCounter(modules=False) as c:
        fn(*args)
    return c.flops


# -- the op counter: tests/test_roofline.py's five --------------------------

def test_loop_flops_match_the_unrolled_count():
    x, w = torch.randn(256, 256), torch.randn(256, 256)

    def loop(x, w):
        for _ in range(8):
            x = x @ w
        return x

    assert flops_of(loop, x, w) == 2 * 256 ** 3 * 8


def test_nested_loop_amplification():
    x, w = torch.randn(128, 128), torch.randn(128, 128)

    def nested(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    assert flops_of(nested, x, w) == 2 * 128 ** 3 * 12


def test_batched_einsum_flops():
    a, b = torch.randn(4, 64, 32), torch.randn(4, 32, 16)
    assert flops_of(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                    a, b) == 2 * 4 * 64 * 32 * 16


def test_bytes_scale_with_loop_length():
    def run(n):
        x = torch.zeros(1024, 1024)
        with OpCounter(modules=False) as c:
            for _ in range(n):
                x = x * 2.0
        return c.bytes

    # 6 extra iterations x (read 4 MB + write 4 MB)
    per_iter = 1024 * 1024 * 4 * 2
    assert abs((run(8) - run(2)) - 6 * per_iter) < per_iter


def test_records_carry_the_kinds_that_ran():
    x = torch.randn(64, 64, requires_grad=True)
    with OpCounter() as c:
        (x @ x).sum().backward()
    kinds = {r["kind"] for r in c.records()}
    assert {"aten.mm", "aten.sum"} <= kinds
    mods = {r["module"] for r in c.records() if r["kind"] == "aten.mm"}
    assert " (backward)" in mods                     # the backward's mm
    assert all(r["count"] >= 1 for r in c.records())


@pytest.mark.parametrize("arch,seq", [("qwen3_8b", 256),
                                      ("xlstm_350m", 1024)])
def test_meta_counts_equal_real_counts(arch, seq, monkeypatch):
    """The online attention's blocks and the recurrences' steps that run
    once for many on meta count what the real loops count: 4 x 4 blocks
    of 64 (qwen3), 4 mLSTM chunks of 256 and 1,024 sLSTM steps (xlstm)."""
    monkeypatch.setattr(flash, "DENSE_LIMIT", 64 * 64)
    monkeypatch.setattr(flash, "online_attention", functools.partial(
        flash.online_attention, chunk_q=64, chunk_k=64))
    cfg = get_smoke(arch).scaled(num_layers=2, compute_dtype="float32",
                                 param_dtype="float32")
    got = []
    for dev in ("cpu", "meta"):
        lm = LM(cfg, device=dev)
        b = {k: torch.zeros((2, seq), dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
        train = flops_of(make_train_step(lm, AdamWConfig()),
                         init_train_state(lm), b)
        with torch.no_grad():
            pre = flops_of(lm.prefill, b["tokens"], seq)
        got.append((train, pre))
    assert got[0] == got[1] and got[0][0] > 0


# -- per device on a fake world ---------------------------------------------

def test_a_sharded_product_counts_its_share_and_its_gather():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    M, K, N = 32, 64, 128
    with dryrun.fake_world(8):
        mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
        x = distribute_tensor(torch.empty(M, K, device="meta"), mesh,
                              [Replicate(), Replicate()])
        w = distribute_tensor(torch.empty(K, N, device="meta"), mesh,
                              [Shard(1), Shard(1)])
        with OpCounter(modules=False) as c:
            y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
    s = c.summary()
    assert s["flops_global"] == 2 * M * K * N
    assert s["flops"] == 2 * M * K * N / 8
    # the gather back: [M, N/8] over the model axis, then [M, N/4] over
    # the data axis, float32 operands
    assert s["collectives"]["all-gather"] == 4 * M * (N // 8 + N // 4)
    assert s["collectives"]["total"] == s["collectives"]["all-gather"]
    assert tuple(y.shape) == (M, N)


# -- the roofline -------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_references(arch, shape):
    kind = SHAPES[shape][2]
    assert roofline.model_flops(arch, shape, kind) == \
        ref_roofline.model_flops(arch, shape, kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_gives_the_references_terms_without_the_peaks(arch):
    shape = applicable_shapes(arch)[-1]
    cell = dict(arch=arch, shape=shape, mesh="pod16x16",
                kind=SHAPES[shape][2], devices=256, flops=3.1e14,
                bytes_accessed=2.7e12, memory={},
                collectives={"all-gather": 4e9, "total": 1.1e10})
    got, want = roofline.analyze(cell), ref_roofline.analyze(cell)
    pairs = ((roofline.PEAK_FLOPS, ref_roofline.PEAK_FLOPS, "t_compute_s"),
             (roofline.HBM_BW, ref_roofline.HBM_BW, "t_memory_s"),
             (roofline.LINK_BW, ref_roofline.LINK_BW, "t_collective_s"))
    for mine, ref, key in pairs:
        assert got[key] * mine == pytest.approx(want[key] * ref, rel=1e-12)
    for key in ("model_flops", "hlo_flops_total", "useful_ratio"):
        assert got[key] == want[key]
    assert set(got) == set(want)
    assert roofline.to_markdown([got]).count("\n") == 2


# -- matrix-product FLOPs against the reference's compiled cells ------------

FAMILIES = ["qwen3_8b", "gemma3_4b", "granite_moe_1b_a400m",
            "deepseek_v2_236b", "zamba2_2p7b", "xlstm_350m",
            "llama32_vision_11b", "hubert_xlarge"]
# relative, measured here: zamba2 0.27 % above the port in the reference,
# whose three-operand Mamba2 einsums contract a decay into an operand by
# a dot with no contracted dim (2 FLOPs a result element) where the port
# multiplies elementwise; xLSTM 0.95 % above (0.09 % in its prefill, where
# XLA turns the mLSTM's normaliser product of one output column, qb @ n,
# into a multiply and a reduction its dot count leaves out; the rest is
# in the differentiated sLSTM time scan and not yet traced; 0.03 % with
# remat on).  The other families are exact.
HLO_TOL = {"xlstm_350m": 1.2e-2, "zamba2_2p7b": 5e-3}
F32 = dict(compute_dtype="float32", param_dtype="float32", remat="none")
B, S = 2, 64


@pytest.mark.parametrize("arch", FAMILIES)
def test_product_flops_equal_the_references_compiled_cells(arch):
    rcfg, pcfg = ref_get_smoke(arch).scaled(**F32), \
        get_smoke(arch).scaled(**F32)
    rlm, lm = RefLM(rcfg), LM(pcfg, device="meta")

    def batch(labels, make):
        out = {}
        if pcfg.family == "audio":
            out["frames"] = make((B, S, 512), True)
        else:
            out["tokens"] = make((B, S), False)
        if labels:
            out["labels"] = make((B, S), False)
        if pcfg.family == "vlm":
            out["vision"] = make((B, pcfg.vlm.num_image_tokens,
                                  pcfg.vlm.vision_dim), True)
        return out

    def jx(shape, f):
        return jax.ShapeDtypeStruct(shape, jnp.float32 if f else jnp.int32)

    def meta(shape, f):
        return torch.empty(shape, dtype=torch.float32 if f else torch.int32,
                           device="meta")

    params = rlm.abstract_params()
    state = RefTrainState(params, jax.eval_shape(ref_optim.init_state,
                                                 params))
    ref_train = analyze_hlo(jax.jit(ref_make_train_step(
        rlm, ref_optim.AdamWConfig())).lower(
            state, batch(True, jx)).compile().as_text())["flops"]
    if pcfg.family == "audio":
        ref_fn = jax.jit(lambda p, b: rlm.forward(p, b))
    else:
        ref_fn = jax.jit(lambda p, b: rlm.prefill(p, b, s_max=S))
    ref_pre = analyze_hlo(ref_fn.lower(params, batch(False, jx)).compile()
                          .as_text())["flops"]
    train = flops_of(make_train_step(lm, AdamWConfig()),
                     init_train_state(lm), batch(True, meta))
    b = batch(False, meta)
    with torch.no_grad():
        if lm.encoder_only:
            pre = flops_of(lm, b["frames"])
        else:
            pre = flops_of(lambda: lm.prefill(b["tokens"], S,
                                              vision=b.get("vision")))
    tol = HLO_TOL.get(arch, 0.0)
    for got, want in ((train, ref_train), (pre, ref_pre)):
        assert want > 0
        assert abs(got / want - 1) <= tol, (got, want)


# -- multi-pod and sp_fsdp cells ----------------------------------------------

# one architecture per family; its cheapest cell on meta
PER_FAMILY = [("qwen3_8b", "decode_32k"), ("granite_moe_1b_a400m",
                                           "decode_32k"),
              ("zamba2_2p7b", "decode_32k"), ("xlstm_350m", "decode_32k"),
              ("llama32_vision_11b", "decode_32k"),
              ("hubert_xlarge", "prefill_32k")]
SP_CELLS = [(a, "prefill_32k") for a, _ in PER_FAMILY] + [
    ("qwen3_8b", "train_4k")]


def check_cell(res, arch, shape, multi_pod, preset):
    assert res["devices"] == (512 if multi_pod else 256)
    assert res["flops"] > 0 and res["flops"] < res["flops_global"]
    assert res["memory"]["argument_size_in_bytes"] == \
        reference_argument_bytes(arch, shape, multi_pod, unit(arch),
                                 preset)
    terms = roofline.analyze(res)
    assert all(math.isfinite(terms[k]) and terms[k] >= 0
               for k in ("t_compute_s", "t_memory_s", "t_collective_s"))
    assert terms["dominant"] in ("compute", "memory", "collective")
    assert np.isfinite(terms["useful_ratio"]) and terms["useful_ratio"] > 0


@pytest.mark.parametrize("arch,shape", PER_FAMILY)
def test_one_arch_per_family_runs_on_the_multi_pod_mesh(arch, shape):
    res = dryrun.run_cell(arch, shape, True,
                          overrides=dict(num_layers=unit(arch)))
    assert res["mesh"] == "pod2x16x16"
    check_cell(res, arch, shape, True, "default")


@pytest.mark.parametrize("arch,shape", SP_CELLS)
def test_one_arch_per_family_runs_under_sp_fsdp(arch, shape):
    res = dryrun.run_cell(arch, shape, False, preset="sp_fsdp",
                          overrides=dict(num_layers=unit(arch)))
    assert res["preset"] == "sp_fsdp"
    check_cell(res, arch, shape, False, "sp_fsdp")
