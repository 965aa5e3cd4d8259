"""The port's training stack against the reference's, on the CPU.

The reference and the port get the same weights (the reference's
``LM.init``, copied through ``interop.lm_state_dict_from_arrays``) and the
same numpy batches from one seed.  Tolerances, each relative to the
largest |value| of the tensor compared:

* ``schedule`` and ``apply_updates`` (float32 and bf16 leaves, with and
  without clipping): 1e-6.  Two exceptions, both measured: with bf16
  leaves the reference's float32 global norm is up to 1e-6 off the
  float64 norm of the same values (the port's about 5e-8), so there the
  norm is held to the float64 norm at 1e-6, and the clipped ``m`` and
  ``v``, which carry the norm's error through the clip scale, to 3e-6;
* the loss of every ported architecture's smoke config in float32: 1e-5,
  and every gradient against ``jax.value_and_grad(lm.loss)``: 1e-4
  (measured: under 1e-6 for both);
* two ``make_train_step`` steps against the reference's (with 1 and 2
  microbatches): the loss and the norm 1e-5, ``m`` and ``v`` 1e-5
  (measured: 1.3e-6), every parameter 1e-4 (measured: 3e-5, in the
  zero-initialised norm scales, whose values are two Adam steps, each an
  ``m / sqrt(v)`` of gradients of ~1e-6 relative error);
* 4 microbatches against the full batch (``grad_clip=0``): rtol 1e-5,
  atol 1e-6, as ``tests/test_train_ft.py``.

Remat and no-remat gradients are bit-equal; crash and resume through the
``Trainer`` is bit-exact; the loss falls over 30 steps.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as ref_get_smoke
from repro.models.model import LM as RefLM
from repro.train import optim as ref_optim
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.configs import get_smoke
from repro_torch.data import JoinCorpus, TokenBatcher
from repro_torch.interop import (lm_arrays_from_state_dict,
                                 lm_reference_name,
                                 lm_state_dict_from_arrays)
from repro_torch.launch import train as launch_train
from repro_torch.models.model import LM
from repro_torch.relational.synth import lastfm_like
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import optim
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

import torch_threads  # noqa: F401

# depth tier: jax compiles each reference model's gradient
pytestmark = pytest.mark.slow

ARCHS = ["qwen3_8b", "gemma3_4b", "starcoder2_3b", "nemotron_4_15b",
         "granite_moe_1b_a400m", "deepseek_v2_236b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
SHAPES = {"a": (64, 32), "b.w": (17,), "c": (3, 5, 7)}


def assert_close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def twin(arch, seed=0, **kw):
    rcfg = ref_get_smoke(arch).scaled(**kw)
    cfg = get_smoke(arch).scaled(**kw)
    ref = RefLM(rcfg)
    params = ref.init(jax.random.key(seed))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_arrays(
        cfg, {k: np.asarray(v, np.float32) for k, v in params.items()}))
    return ref, params, lm


def batch_of(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 1), (2, 10)])
def test_schedule_matches_reference(warmup, total):
    kw = dict(warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 2, 5, 10, 11, 100, 10_000, 20_000):
        want = float(ref_optim.schedule(ref_optim.AdamWConfig(**kw),
                                        jnp.int32(step)))
        got = optim.schedule(optim.AdamWConfig(**kw),
                             torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert_close(float(got), want, 1e-6, f"step {step}")


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(dtype, clip):
    rng = np.random.default_rng(1)
    kw = dict(grad_clip=clip, warmup_steps=2, total_steps=10)
    rcfg, cfg = ref_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    rp = {k: jnp.asarray(v).astype(dtype) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p0.items()}
    rs, ts = ref_optim.init_state(rp), optim.init_state(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    mv_tol = 3e-6 if clip and dtype == "bfloat16" else 1e-6
    for i in range(4):
        g = {k: (rng.normal(size=s) * (3 if clip else 0.1)).astype(
            np.float32) for k, s in SHAPES.items()}
        rg = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
              for k, v in g.items()}
        rp, rs, rm = ref_optim.apply_updates(rcfg, rp, rg, rs)
        tp, ts, tm = optim.apply_updates(cfg, tp, tg, ts)
        assert int(ts.step) == int(rs.step) == i + 1
        assert_close(float(tm["lr"]), float(rm["lr"]), 1e-6, "lr")
        if dtype == "bfloat16":
            exact = np.sqrt(sum((f32(v).astype(np.float64) ** 2).sum()
                                for v in tg.values()))
            assert_close(float(tm["grad_norm"]), exact, 1e-6, "grad_norm")
        else:
            assert_close(float(tm["grad_norm"]), float(rm["grad_norm"]),
                         1e-6, "grad_norm")
        for k in SHAPES:
            assert tp[k].dtype == getattr(torch, dtype)
            assert ts.m[k].dtype == ts.v[k].dtype == torch.float32
            assert_close(f32(tp[k]), f32(rp[k]), 1e-6, f"params {k}")
            assert_close(f32(ts.m[k]), f32(rs.m[k]), mv_tol, f"m {k}")
            assert_close(f32(ts.v[k]), f32(rs.v[k]), mv_tol, f"v {k}")


def test_apply_updates_in_chunks_equals_one_chunk(monkeypatch):
    """The chunked update (and norm) is the same arithmetic per element."""
    rng = np.random.default_rng(2)
    p = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for k, s in SHAPES.items()}
    g = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for k, s in SHAPES.items()}
    cfg = optim.AdamWConfig(grad_clip=0.0, warmup_steps=0)
    whole = optim.apply_updates(cfg, {k: v.clone() for k, v in p.items()},
                                g, optim.init_state(p))
    monkeypatch.setattr(optim, "UPDATE_CHUNK", 7)
    chunked = optim.apply_updates(cfg, {k: v.clone() for k, v in p.items()},
                                  g, optim.init_state(p))
    for a, b in zip(whole[:2], chunked[:2]):
        for k in SHAPES:
            assert torch.equal((a if isinstance(a, dict) else a.m)[k],
                               (b if isinstance(b, dict) else b.m)[k])


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    ref, params, lm = twin(arch, **F32)
    b = batch_of(lm.cfg)
    loss, grads = jax.jit(jax.value_and_grad(ref.loss))(params, jax_batch(b))
    named = dict(lm.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    got = lm.loss(torch_batch(b))
    tg = torch.autograd.grad(got, list(named.values()))
    assert_close(float(got.detach()), float(loss), 1e-5, "loss")
    for (name, _), g in zip(named.items(), tg):
        ref_name, idx = lm_reference_name(name)
        assert_close(f32(g), np.asarray(grads[ref_name])[idx], 1e-4, name)


@pytest.mark.parametrize("arch", ["qwen3_8b", "deepseek_v2_236b"])
def test_grads_through_the_online_attention_match_reference(arch,
                                                            monkeypatch):
    """Every attention on the online-softmax path (``DENSE_LIMIT = 1``)
    in 8-position blocks in both packages: the port's output is written
    block by block into ``torch.empty``, and autograd passes through it
    (loss 1e-5, gradients 1e-4, as above; MLA's online path too)."""
    from repro.models import flash as ref_flash
    from repro_torch.models import flash
    for mod in (flash, ref_flash):
        monkeypatch.setattr(mod, "DENSE_LIMIT", 1)
        monkeypatch.setattr(mod, "online_attention", functools.partial(
            mod.online_attention, chunk_q=8, chunk_k=8))
    test_loss_and_grads_match_reference(arch)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    ref, params, lm = twin("qwen3_8b", **F32)
    ocfg = dict(warmup_steps=2, total_steps=10)
    b = batch_of(lm.cfg, B=4, S=16)
    rstep = jax.jit(ref_make_train_step(ref, ref_optim.AdamWConfig(**ocfg),
                                        microbatches=microbatches))
    rstate = RefTrainState(params, ref_optim.init_state(params))
    step = make_train_step(lm, optim.AdamWConfig(**ocfg),
                           microbatches=microbatches)
    state = init_train_state(lm)
    for i in range(2):
        rstate, rm = rstep(rstate, jax_batch(b))
        state, m = step(state, torch_batch(b))
        assert_close(float(m["loss"]), float(rm["loss"]), 1e-5, "loss")
        assert_close(float(m["grad_norm"]), float(rm["grad_norm"]), 1e-5,
                     "grad_norm")
    assert int(state.opt.step) == int(rstate.opt.step) == 2
    want = rstate.params
    for name, p in state.params.items():
        ref_name, idx = lm_reference_name(name)
        assert_close(f32(p), np.asarray(want[ref_name])[idx], 1e-4, name)
        assert_close(f32(state.opt.m[name]),
                     np.asarray(rstate.opt.m[ref_name])[idx], 1e-5, name)
        assert_close(f32(state.opt.v[name]),
                     np.asarray(rstate.opt.v[ref_name])[idx], 1e-5, name)


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma3_4b",
                                  "granite_moe_1b_a400m"])
def test_remat_and_no_remat_grads_are_bit_equal(arch):
    cfg = get_smoke(arch).scaled(**F32)
    b = torch_batch(batch_of(cfg))
    out = {}
    for remat in ("block", "none"):
        lm = LM(cfg.scaled(remat=remat), device="cpu",
                generator=torch.Generator().manual_seed(3))
        params = [p.requires_grad_(True) for p in lm.parameters()]
        loss = lm.loss(b)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, params))
    assert torch.equal(out["block"][0], out["none"][0])
    for a, c in zip(out["block"][1], out["none"][1]):
        assert torch.equal(a, c)


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    from repro_torch.models import blocks
    cfg = get_smoke("qwen3_8b").scaled(**F32)
    calls = [0]
    forward = blocks.TransformerBlock.forward

    def counted(self, *args):
        calls[0] += 1
        return forward(self, *args)

    monkeypatch.setattr(blocks.TransformerBlock, "forward", counted)
    out = {}
    for remat in ("block", "none"):
        lm = LM(cfg.scaled(remat=remat), device="cpu")
        params = [p.requires_grad_(True) for p in lm.parameters()]
        calls[0] = 0
        torch.autograd.grad(lm.loss(torch_batch(batch_of(cfg))), params)
        with torch.no_grad():           # no grad, no checkpoint
            lm.loss(torch_batch(batch_of(cfg)))
        out[remat] = calls[0]
    L = cfg.num_layers
    assert out == {"block": 3 * L, "none": 2 * L}


# ---------------------------------------------------------------------------
# the trainer (tests/test_train_ft.py's behaviours in the port)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    cat, queries = lastfm_like(n_users=60, n_artists=50, artists_per_user=4,
                               friends_per_user=3)
    return JoinCorpus.build(cat, queries["lastfm_A1"], vocab=256,
                            device="cpu")


def tiny_trainer(corpus, tmp_path, steps=8, crash_after=None,
                 microbatches=1):
    cfg = get_smoke("qwen3_8b").scaled(num_layers=2, vocab=256)
    batcher = TokenBatcher(corpus, batch=4, seq=16, device="cpu")
    tcfg = TrainerConfig(steps=steps, checkpoint_every=4,
                         checkpoint_dir=str(tmp_path / "ckpt"),
                         log_every=4, crash_after_step=crash_after,
                         microbatches=microbatches)
    return Trainer(lambda gen: LM(cfg, device="cpu", generator=gen),
                   optim.AdamWConfig(warmup_steps=2, total_steps=steps),
                   batcher, tcfg, device="cpu")


def test_training_reduces_loss(corpus, tmp_path):
    trainer = tiny_trainer(corpus, tmp_path, steps=30)
    trainer.run()
    losses = [m["loss"] for m in trainer.metrics_log]
    assert [m["step"] for m in trainer.metrics_log] == [4, 8, 12, 16, 20,
                                                        24, 28, 30]
    assert set(trainer.metrics_log[0]) == {"loss", "lr", "grad_norm",
                                           "step"}
    assert losses[-1] < losses[0], losses
    assert len(trainer.step_seconds) == len(losses)


def test_crash_and_resume_is_bit_exact(corpus, tmp_path):
    ref_state = tiny_trainer(corpus, tmp_path / "ref").run(seed=7)
    crashed = tiny_trainer(corpus, tmp_path / "crash", crash_after=6)
    with pytest.raises(RuntimeError, match="injected failure"):
        crashed.run(seed=7)
    resumed = tiny_trainer(corpus, tmp_path / "crash")
    res_state = resumed.run(seed=7)
    assert res_state.params.keys() == ref_state.params.keys()
    for k in ref_state.params:
        assert torch.equal(ref_state.params[k], res_state.params[k]), k
        assert torch.equal(ref_state.opt.m[k], res_state.opt.m[k]), k
        assert torch.equal(ref_state.opt.v[k], res_state.opt.v[k]), k
    assert int(res_state.opt.step) == int(ref_state.opt.step) == 8
    # the resumed run's model holds the resumed parameters
    assert all(p is res_state.params[n]
               for n, p in resumed.lm.named_parameters())


def test_microbatch_accumulation_matches_full_batch():
    cfg = get_smoke("qwen3_8b").scaled(num_layers=2, **F32)
    b = torch_batch(batch_of(cfg, B=8, S=16))
    ocfg = optim.AdamWConfig(grad_clip=0.0)  # clip is batch-statistic dependent
    out = []
    for mb in (1, 4):
        lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        state, _ = make_train_step(lm, ocfg, microbatches=mb)(
            init_train_state(lm), b)
        out.append(state)
    for k in out[0].params:
        np.testing.assert_allclose(f32(out[0].params[k]),
                                   f32(out[1].params[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_train_step_refuses_a_foreign_state():
    cfg = get_smoke("qwen3_8b").scaled(num_layers=2)
    lm = LM(cfg, device="cpu")
    other = LM(cfg, device="cpu")
    step = make_train_step(lm, optim.AdamWConfig())
    with pytest.raises(ValueError, match="not the model's parameters"):
        step(init_train_state(other), torch_batch(batch_of(cfg)))
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(lm, optim.AdamWConfig(), microbatches=0)


def test_serving_after_training_runs_without_gradients():
    cfg = get_smoke("qwen3_8b").scaled(num_layers=2)
    lm = LM(cfg, device="cpu")
    state = init_train_state(lm)
    step = make_train_step(lm, optim.AdamWConfig())
    state, _ = step(state, torch_batch(batch_of(cfg)))
    assert all(p.requires_grad for p in lm.parameters())
    toks = {"tokens": torch.from_numpy(batch_of(cfg, B=2, S=8)["tokens"])}
    out = ServeEngine(lm, ServeConfig(max_seq=12), device="cpu").generate(
        toks, 4)
    assert out.shape == (2, 4)
    with torch.inference_mode():
        logits = lm(toks["tokens"])
    assert not logits.requires_grad


@pytest.mark.parametrize("arch", ["qwen3_8b", "zamba2_2p7b", "xlstm_350m"])
def test_launch_train_cli_on_the_cpu(arch, tmp_path, capsys):
    launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--checkpoint-dir", str(tmp_path / "c"),
                       "--checkpoint-every", "2"])
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("step")]
    assert [int(r[1]) for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(float(r[3])) for r in rows)
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == [
        "step_0000000002", "step_0000000004"]
    # the token corpus has no images or frames for these families
    for other, needs in (("llama32_vision_11b", "image context"),
                         ("hubert_xlarge", "audio frames")):
        with pytest.raises(SystemExit, match=f"needs {needs} .* the "
                           "training corpus holds only tokens"):
            launch_train.main(["--arch", other, "--smoke", "--device",
                               "cpu"])
