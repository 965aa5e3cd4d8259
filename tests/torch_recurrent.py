"""LM-level parity tests shared by the two recurrent families.

``tests/test_torch_ssm.py`` (hybrid: zamba2) and ``tests/test_torch_xlstm.py``
(ssm: xlstm) import these tests and give each its architecture through a
module fixture ``arch``.  Each case builds the reference's smoke model at a
depth that runs units and a tail (``DEPTH``), initialises it with
``LM.init``, moves every constant parameter (the zero norm scales, Mamba2's
``A_log``, ``dt_bias`` and ``D``) off its constant with seeded numpy noise,
and loads the same weights into the port through
``interop.lm_state_dict_from_arrays``.

Tolerances: float32 logits to ``atol = rtol = 1e-4`` against the reference;
bfloat16 logits to ``1e-2 * max|reference logits|``; prefill plus stepwise
decode against the teacher-forced forward at the reference's own
tolerances (``tests/test_models.py``: 2e-2, then 3e-2) and within the port
at 1e-4; the loss to 1e-5 and every gradient to 1e-5 of the tensor's
largest |value| against ``jax.value_and_grad``; two train steps as
``tests/test_torch_train.py`` holds them (loss, norm, ``m``, ``v`` 1e-5,
parameters 1e-4); checkpoints and interop bit for bit.
"""

import copy
import json
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.checkpoint.store import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models.attention import KVCache as RefKVCache
from repro.models.model import LM as RefLM
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefEngine
from repro.train import optim as ref_optim
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint import store
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import (lm_arrays_from_state_dict,
                                 lm_reference_name,
                                 lm_state_dict_from_arrays)
from repro_torch.models.attention import KVCache
from repro_torch.models.model import LM
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import optim
from repro_torch.train.train_step import init_train_state, make_train_step

# units and a tail: zamba2 2 units (attn_every 2) + 1 Mamba2 layer,
# xlstm 1 mLSTM+sLSTM unit + 1 mLSTM layer
DEPTH = {"zamba2_2p7b": 5, "xlstm_350m": 3}
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def configs(arch, dtype="float32", **extra):
    """(reference cfg, port cfg): the same smoke configuration."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype,
              num_layers=DEPTH[arch], **extra)
    return ref_get_smoke(arch).scaled(**kw), get_smoke(arch).scaled(**kw)


def reference_arrays(rcfg, seed):
    """The reference's initial parameters as float32 numpy, every constant
    one moved off its constant by seeded noise."""
    params = RefLM(rcfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(params):
        a = np.asarray(params[k], np.float32)
        if np.ptp(a) == 0:
            a = a + (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        out[k] = a
    return out


def twin_models(arch, dtype="float32", seed=0, **extra):
    """The reference's (lm, params) and the port's LM on the same
    weights."""
    rcfg, pcfg = configs(arch, dtype, **extra)
    ref = RefLM(rcfg)
    arrays = reference_arrays(rcfg, seed)
    shapes = ref.abstract_params()
    params = {k: jnp.asarray(a).astype(shapes[k].dtype)
              for k, a in arrays.items()}
    port = LM(pcfg, device="cpu")
    port.load_state_dict(lm_state_dict_from_arrays(
        pcfg, {k: np.asarray(v, np.float32) for k, v in params.items()}))
    return ref, params, port


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def logits_of(a, cfg):
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    return np.asarray(a, np.float32)[..., :cfg.vocab]


def assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * float(np.abs(want).max()))


def assert_rel(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def batch_of(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def state_tensors(caches):
    """Every tensor of the nested caches (KV caches and recurrent states),
    in order."""
    if isinstance(caches, (list, tuple)):
        return [t for c in caches for t in state_tensors(c)]
    return [getattr(caches, f.name) for f in dataclasses.fields(caches)
            if isinstance(getattr(caches, f.name), torch.Tensor)]


def stacked_states(cache):
    """A stack's recurrent states (KV caches left out) as the reference
    stacks them: each field with the layers on its leading axes."""
    if isinstance(cache, list):
        return [np.stack(z) for z in zip(*map(stacked_states, cache))]
    if isinstance(cache, tuple):
        return [a for c in cache for a in stacked_states(c)]
    if isinstance(cache, KVCache):
        return []
    return [getattr(cache, f.name).float().numpy()
            for f in dataclasses.fields(cache)]


def reference_states(cache):
    """The same leaves of the reference's caches."""
    if isinstance(cache, RefKVCache):
        return []
    if hasattr(cache, "_fields"):
        return [np.asarray(getattr(cache, f), np.float32)
                for f in cache._fields]
    return [a for c in cache for a in reference_states(c)]


# ---------------------------------------------------------------------------
# the LM against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, dtype):
    ref, params, port = twin_models(arch, dtype)
    assert list(port.segments) == ["units", "tail"]
    toks = tokens(port.cfg, (2, 32), seed=1)
    want = logits_of(jax.jit(ref.forward)(
        params, {"tokens": jnp.asarray(toks)}), port.cfg)
    with torch.inference_mode():
        out = port(torch.from_numpy(toks))
    assert out.shape == (2, 32, port.vocab_padded)
    got = logits_of(out, port.cfg)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.parametrize("k", [8, 32])
def test_prefill_and_decode_match_reference(arch, k):
    """prefill + decode_step logits, step by step, against the
    reference's (float32; zamba2's smoke prefill in one Mamba2 chunk and
    in two), and the final states."""
    ref, params, port = twin_models(arch, seed=1)
    B, S = 2, k + 8
    toks = tokens(port.cfg, (B, S), seed=2)
    r_logits, r_caches = jax.jit(functools.partial(ref.prefill, s_max=S))(
        params, {"tokens": jnp.asarray(toks[:, :k])})
    r_decode = jax.jit(ref.decode_step)
    with torch.inference_mode():
        logits, caches = port.prefill(torch.from_numpy(toks[:, :k]), S)
        np.testing.assert_allclose(logits_of(logits, port.cfg),
                                   logits_of(r_logits, port.cfg), **F32_TOL)
        for t in range(k, S):
            step = toks[:, t:t + 1]
            r_logits, r_caches = r_decode(params, jnp.asarray(step),
                                          r_caches)
            logits, caches = port.decode_step(torch.from_numpy(step), caches)
            np.testing.assert_allclose(logits_of(logits, port.cfg),
                                       logits_of(r_logits, port.cfg),
                                       **F32_TOL)
    # the recurrent states end where the reference's do
    want = reference_states(r_caches)
    got = [a for seg in caches for a in stacked_states(seg)]
    assert want and [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_prefill_decode_matches_forward(arch):
    """The reference's test_prefill_decode_matches_forward on the port,
    at its tolerances, and within the port at 1e-4."""
    _, pcfg = configs(arch)
    lm = LM(pcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    B, S, k = 2, 16, 8
    toks = torch.from_numpy(tokens(pcfg, (B, S), seed=3))
    with torch.inference_mode():
        full = lm(toks)
        logits, caches = lm.prefill(toks[:, :k], S)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, k - 1].numpy(), rtol=2e-2,
                                   atol=2e-2)
        steps = [logits[:, 0]]
        for t in range(k, S):
            logits, caches = lm.decode_step(toks[:, t:t + 1], caches)
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       full[:, t].numpy(), rtol=3e-2,
                                       atol=3e-2)
            steps.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(steps[:-1], 1),
                               full[:, k - 1:S - 1], **F32_TOL)


def test_decode_advances_the_state(arch):
    """Every recurrent state tensor moves at each decode step, and a step
    from a stale copy of the caches gives other logits."""
    _, pcfg = configs(arch)
    lm = LM(pcfg, device="cpu", generator=torch.Generator().manual_seed(2))
    toks = torch.from_numpy(tokens(pcfg, (2, 12), seed=4))
    with torch.inference_mode():
        _, caches = lm.prefill(toks[:, :8], 12)
        stale = copy.deepcopy(caches)
        lm.decode_step(toks[:, 8:9], caches)
        moved = [not torch.equal(a, b) for a, b in
                 zip(state_tensors(stale), state_tensors(caches))]
        assert moved and all(moved), moved
        good, _ = lm.decode_step(toks[:, 9:10], caches)
        old, _ = lm.decode_step(toks[:, 9:10], stale)
    assert float((good - old).abs().max()) > 1e-3


def test_loss_and_grads_match_reference(arch):
    ref, params, lm = twin_models(arch)
    b = batch_of(lm.cfg)
    loss, grads = jax.jit(jax.value_and_grad(ref.loss))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    named = dict(lm.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    got = lm.loss({k: torch.from_numpy(v) for k, v in b.items()})
    tg = torch.autograd.grad(got, list(named.values()))
    assert_rel(float(got.detach()), float(loss), 1e-5, "loss")
    for (name, _), g in zip(named.items(), tg):
        ref_name, idx = lm_reference_name(name, lm.reference_prefixes)
        assert_rel(f32(g), np.asarray(grads[ref_name])[idx], 1e-5, name)


def test_train_step_matches_reference(arch):
    ref, params, lm = twin_models(arch)
    ocfg = dict(warmup_steps=2, total_steps=10)
    b = batch_of(lm.cfg, B=4, S=16)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    rstep = jax.jit(ref_make_train_step(ref, ref_optim.AdamWConfig(**ocfg)))
    rstate = RefTrainState(params, ref_optim.init_state(params))
    step = make_train_step(lm, optim.AdamWConfig(**ocfg))
    state = init_train_state(lm)
    for _ in range(2):
        rstate, rm = rstep(rstate, jb)
        state, m = step(state, tb)
        assert_rel(float(m["loss"]), float(rm["loss"]), 1e-5, "loss")
        assert_rel(float(m["grad_norm"]), float(rm["grad_norm"]), 1e-5,
                   "grad_norm")
    for name, p in state.params.items():
        ref_name, idx = lm_reference_name(name, lm.reference_prefixes)
        assert_rel(f32(p), np.asarray(rstate.params[ref_name])[idx], 1e-4,
                   name)
        assert_rel(f32(state.opt.m[name]),
                   np.asarray(rstate.opt.m[ref_name])[idx], 1e-5, name)
        assert_rel(f32(state.opt.v[name]),
                   np.asarray(rstate.opt.v[ref_name])[idx], 1e-5, name)


def test_remat_and_no_remat_grads_are_bit_equal(arch):
    _, cfg = configs(arch)
    b = {k: torch.from_numpy(v) for k, v in batch_of(cfg).items()}
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


def test_greedy_generation_matches_reference(arch):
    ref, params, lm = twin_models(arch)
    toks = tokens(lm.cfg, (3, 16), seed=0)
    want = RefEngine(ref, params, RefServeConfig(max_seq=32)).generate(
        {"tokens": jnp.asarray(toks)}, max_new=8, seed=1)
    got = ServeEngine(lm, ServeConfig(max_seq=32), device="cpu").generate(
        {"tokens": toks}, max_new=8, seed=1)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# names, shapes, checkpoints
# ---------------------------------------------------------------------------

def test_interop_round_trip(arch):
    """reference params (bf16; the float32 ones float32) -> port state dict
    -> reference names and stacked shapes, bit for bit."""
    rcfg, pcfg = configs(arch, "bfloat16")
    params = RefLM(rcfg).init(jax.random.key(5))
    arrays = {k: np.asarray(v, np.float32) for k, v in params.items()}
    state = lm_state_dict_from_arrays(pcfg, arrays)
    lm = LM(pcfg, device="cpu")
    prefixes = lm.reference_prefixes
    for key, t in state.items():
        want = params[lm_reference_name(key, prefixes)[0]].dtype
        assert str(t.dtype) == f"torch.{want}", key
    back = lm_arrays_from_state_dict(state, prefixes)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    lm.load_state_dict(state)
    again = lm_arrays_from_state_dict(lm.state_dict(), prefixes)
    assert all(np.array_equal(again[k], arrays[k]) for k in arrays)


def test_full_width_shapes_match_reference(arch):
    """The full configuration on the meta device: every parameter has the
    reference's shape and dtype, and nothing is allocated."""
    ref_shapes = RefLM(ref_get_config(arch)).abstract_params()
    lm = LM(get_config(arch), device="meta")
    assert all(p.device.type == "meta" for p in lm.parameters())
    by_ref = {}
    for key, t in lm.state_dict().items():
        ref, idx = lm_reference_name(key, lm.reference_prefixes)
        by_ref.setdefault(ref, []).append((idx, tuple(t.shape), t.dtype))
    assert set(by_ref) == set(ref_shapes)
    for ref, parts in by_ref.items():
        want = ref_shapes[ref]
        lead = tuple(np.max([i for i, _, _ in parts], axis=0) + 1) \
            if parts[0][0] else ()
        assert lead + parts[0][1] == tuple(want.shape), ref
        assert len(parts) == int(np.prod(lead, dtype=np.int64))
        assert all(str(dt) == f"torch.{want.dtype}" for _, _, dt in parts)
    n_ref = sum(int(np.prod(s.shape)) for s in ref_shapes.values())
    assert sum(p.numel() for p in lm.parameters()) == n_ref


def test_meta_build_then_init_equals_a_direct_build(arch):
    _, cfg = configs(arch)
    direct = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    lazy = LM(cfg, device="meta").to_empty(device="cpu")
    lazy.init_weights(torch.Generator().manual_seed(7))
    for (k, a), (_, b) in zip(direct.state_dict().items(),
                              lazy.state_dict().items()):
        assert torch.equal(a, b), k
    # the reference's initialisers: D ones, the other vectors zeros
    for k, t in direct.state_dict().items():
        if k.endswith((".D",)):
            assert bool((t == 1).all()), k
        elif k.endswith((".A_log", ".dt_bias", "norm", ".ln", ".ln1",
                         ".ln2")):
            assert not t.any(), k


def ref_state(arch, seed=0):
    """The reference's TrainState of the smoke model (bf16 parameters),
    with a non-zero step and moments."""
    params = RefLM(configs(arch, "bfloat16")[0]).init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    moments = [{k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
                for k, v in params.items()} for _ in range(2)]
    return RefTrainState(params, ref_optim.AdamWState(
        jnp.asarray(5, jnp.int32), *moments))


def test_checkpoint_keys_equal_the_reference_flatten(arch):
    ref_items = ref_flatten(ref_state(arch))[0]
    lm = LM(configs(arch, "bfloat16")[1], device="cpu")
    leaves = store._flatten(init_train_state(lm),
                            prefixes=lm.reference_prefixes)
    assert [l.key for l in leaves] == [k for k, _ in ref_items]
    ref_leaves = dict(ref_items)
    for l in leaves:
        assert l.shape == list(ref_leaves[l.key].shape), l.key
        assert l.dtype == str(ref_leaves[l.key].dtype), l.key


def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    rs = ref_state(arch)
    d = str(tmp_path / "c")
    ref_save(d, 5, rs, extra={"batcher": {"cursor": 9}})
    lm = LM(configs(arch, "bfloat16")[1], device="cpu")
    prefixes = lm.reference_prefixes
    back, step, extra = restore_checkpoint(d, init_train_state(lm),
                                           into=True, prefixes=prefixes)
    assert step == 5 and extra == {"batcher": {"cursor": 9}}
    for name, p in lm.named_parameters():
        ref_name, idx = lm_reference_name(name, prefixes)
        assert back.params[name] is p
        assert str(p.dtype) == f"torch.{rs.params[ref_name].dtype}"
        want = np.asarray(rs.params[ref_name].astype(jnp.float32))[idx]
        np.testing.assert_array_equal(f32(p), want, err_msg=name)
        for tree, ref_tree in ((back.opt.m, rs.opt.m),
                               (back.opt.v, rs.opt.v)):
            np.testing.assert_array_equal(
                tree[name].numpy(), np.asarray(ref_tree[ref_name])[idx],
                err_msg=name)


def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    lm = LM(configs(arch, "bfloat16")[1], device="cpu")
    prefixes = lm.reference_prefixes
    rng = np.random.default_rng(1)
    b = {k: torch.from_numpy(rng.integers(0, lm.cfg.vocab, (2, 16)))
         for k in ("tokens", "labels")}
    state, _ = make_train_step(lm, optim.AdamWConfig())(
        init_train_state(lm), b)
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, state, extra={"batcher": {"cursor": 4}},
                    prefixes=prefixes)
    like = ref_state(arch)
    back, step, extra = ref_restore(d, like)
    assert step == 1 and extra == {"batcher": {"cursor": 4}}
    want = lm_arrays_from_state_dict(dict(lm.named_parameters()), prefixes)
    assert set(want) == set(back.params)
    for k, v in want.items():
        assert back.params[k].dtype == like.params[k].dtype
        np.testing.assert_array_equal(np.asarray(back.params[k], np.float32),
                                      v, err_msg=k)
    for mine, theirs in ((state.opt.m, back.opt.m),
                         (state.opt.v, back.opt.v)):
        for k, v in lm_arrays_from_state_dict(mine, prefixes).items():
            np.testing.assert_array_equal(np.asarray(theirs[k]), v,
                                          err_msg=k)


def test_trainer_checkpoints_under_the_reference_names(arch, tmp_path):
    """The Trainer saves the model's parameters under the reference's
    names (its ``reference_prefixes``), and resumes from them."""
    from repro_torch.data import JoinCorpus, TokenBatcher
    from repro_torch.relational.synth import figure1
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cat, q = figure1()
    cfg = configs(arch, "bfloat16")[1]
    corpus = JoinCorpus.build(cat, q, vocab=cfg.vocab, device="cpu")

    def trainer(steps):
        return Trainer(lambda gen: LM(cfg, device="cpu", generator=gen),
                       optim.AdamWConfig(),
                       TokenBatcher(corpus, 2, 16, device="cpu"),
                       TrainerConfig(steps=steps, checkpoint_every=2,
                                     checkpoint_dir=str(tmp_path / "c"),
                                     log_every=1), device="cpu")

    first = trainer(2)
    first.run()
    path = tmp_path / "c" / "step_0000000002" / "manifest.json"
    keys = [leaf["key"] for leaf in json.loads(path.read_text())["leaves"]]
    assert keys == [k for k, _ in ref_flatten(ref_state(arch))[0]]
    resumed = trainer(3)
    state = resumed.run()
    assert int(state.opt.step) == 3
    assert [m["step"] for m in resumed.metrics_log] == [3]
