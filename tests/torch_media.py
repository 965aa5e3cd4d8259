"""LM-level parity tests shared by the vlm and audio families.

``tests/test_torch_vlm.py`` (Llama-3.2-Vision: image cross-attention) and
``tests/test_torch_audio.py`` (HuBERT: a non-causal encoder on frame
embeddings) import these tests and give each its architecture through a
module fixture ``arch``.  Each case builds the reference's smoke model at
a depth that runs units and a tail (``DEPTH``: the vlm's two units of one
self-attention and one cross-attention layer plus a tail layer; 4 audio
blocks), initialises it with ``LM.init``, moves every constant parameter
(the zero norm scales, ``vision_norm`` among them) off its constant with
seeded numpy noise, and loads the same weights into the port through
``interop.lm_state_dict_from_arrays``.  Inputs are drawn with numpy as
``tests/test_models.py`` draws them: tokens, or ``[B, S, 512]`` frames,
labels, and ``[B, num_image_tokens, vision_dim]`` image context.

Tolerances: float32 logits to ``atol = rtol = 1e-4`` against the
reference; bfloat16 logits against the float32 logits of the same
(bf16-valued) weights, no further from them than 1.5 times the
reference's bfloat16 logits are (at 4-5 layers each package lands about
1e-2 * max|logits| away, in its own rounding order, so their difference
alone can pass the 2-layer models' 1e-2; it is held to 2e-2); the loss
to 1e-5 and every gradient to 1e-5 of the tensor's largest |value|
against ``jax.value_and_grad``; two train steps as
``tests/test_torch_train.py`` holds them (loss, norm, ``m``, ``v`` 1e-5,
parameters 1e-4); checkpoints and interop bit for bit.
"""

import json

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
from repro.models.model import LM as RefLM
from repro.train import optim as ref_optim
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint import store
from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import (lm_arrays_from_state_dict,
                                 lm_reference_name,
                                 lm_state_dict_from_arrays)
from repro_torch.models.model import FRAME_DIM, LM
from repro_torch.train import optim
from repro_torch.train.train_step import init_train_state, make_train_step

from torch_recurrent import assert_rel, f32, logits_of, reference_arrays

# vlm: 2 units (cross_attn_every 2: one self + one cross layer) + 1 tail
# layer; audio: 4 non-causal blocks
DEPTH = {"llama32_vision_11b": 5, "hubert_xlarge": 4}
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def configs(arch, dtype="float32", **extra):
    """(reference cfg, port cfg): the same smoke configuration."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype,
              num_layers=DEPTH[arch], **extra)
    return ref_get_smoke(arch).scaled(**kw), get_smoke(arch).scaled(**kw)


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


def batch_of(cfg, B=2, S=32, seed=0):
    """numpy inputs as tests/test_models.py draws them: tokens or frames,
    labels, and the vlm's image context."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        b = {"frames": rng.normal(size=(B, S, FRAME_DIM)).astype(np.float32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["vision"] = rng.normal(size=(B, cfg.vlm.num_image_tokens,
                                       cfg.vlm.vision_dim)).astype(np.float32)
    return b


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def port_forward(lm, b):
    """The port's forward on a numpy batch."""
    inputs = b["frames"] if lm.cfg.family == "audio" else b["tokens"]
    vision = b.get("vision")
    return lm(torch.from_numpy(inputs), vision=None if vision is None
              else torch.from_numpy(vision))


# ---------------------------------------------------------------------------
# the LM against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, dtype):
    ref, params, port = twin_models(arch, dtype)
    b = batch_of(port.cfg, seed=1)
    want = logits_of(jax.jit(ref.forward)(params, to_jax(b)), port.cfg)
    with torch.inference_mode():
        out = port_forward(port, b)
    assert out.shape == (2, 32, port.vocab_padded)
    assert out.dtype == torch.float32
    assert bool((out[..., port.cfg.vocab:] == -1e30).all()) \
        or port.vocab_padded == port.cfg.vocab
    got = logits_of(out, port.cfg)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    # the float32 result of the same bf16-valued weights
    f32cfg = port.cfg.scaled(param_dtype="float32", compute_dtype="float32")
    exact = LM(f32cfg, device="cpu")
    exact.load_state_dict({k: v.float() for k, v in
                           port.state_dict().items()})
    with torch.inference_mode():
        truth = logits_of(port_forward(exact, b), port.cfg)
    scale = float(np.abs(want).max())
    ours = float(np.abs(got - truth).max())
    theirs = float(np.abs(want - truth).max())
    assert ours <= 1.5 * theirs, (ours / scale, theirs / scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)


def test_loss_and_grads_match_reference(arch):
    ref, params, lm = twin_models(arch)
    b = batch_of(lm.cfg)
    loss, grads = jax.jit(jax.value_and_grad(ref.loss))(params, to_jax(b))
    named = dict(lm.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    got = lm.loss(to_torch(b))
    tg = torch.autograd.grad(got, list(named.values()))
    assert_rel(float(got.detach()), float(loss), 1e-5, "loss")
    for (name, _), g in zip(named.items(), tg):
        ref_name, idx = lm_reference_name(name, lm.reference_prefixes)
        assert_rel(f32(g), np.asarray(grads[ref_name])[idx], 1e-5, name)
        assert float(g.abs().max()) > 0, name


def test_train_step_matches_reference(arch):
    ref, params, lm = twin_models(arch)
    ocfg = dict(warmup_steps=2, total_steps=10)
    b = batch_of(lm.cfg, B=4, S=16)
    rstep = jax.jit(ref_make_train_step(ref, ref_optim.AdamWConfig(**ocfg)))
    rstate = RefTrainState(params, ref_optim.init_state(params))
    step = make_train_step(lm, optim.AdamWConfig(**ocfg))
    state = init_train_state(lm)
    for _ in range(2):
        rstate, rm = rstep(rstate, to_jax(b))
        state, m = step(state, to_torch(b))
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


def test_microbatched_step_splits_every_input(arch):
    """Two microbatches of 2 against one batch of 4: the image context
    and the frames are split with the tokens (float32 sums)."""
    _, cfg = configs(arch)
    b = to_torch(batch_of(cfg, B=4, S=16, seed=3))
    out = []
    for micro in (1, 2):
        lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
        state, m = make_train_step(lm, optim.AdamWConfig(), microbatches=micro)(
            init_train_state(lm), b)
        out.append((float(m["loss"]), {n: p.detach().clone()
                                       for n, p in state.params.items()}))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    for n, p in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], p, atol=1e-5, rtol=1e-4)


def test_remat_and_no_remat_grads_are_bit_equal(arch):
    """Per-block recomputation carries the image context (vlm) through
    the backward pass: every gradient, ``vision_norm``'s included, is
    bit-equal to the run that keeps the activations."""
    _, cfg = configs(arch)
    b = to_torch(batch_of(cfg))
    out = {}
    for remat in ("block", "none"):
        lm = LM(cfg.scaled(remat=remat), device="cpu",
                generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            for p in lm.parameters():
                if not p.any():         # the zero norm scales
                    p.normal_(0, 0.1, generator=torch.Generator()
                              .manual_seed(p.numel()))
        params = [p.requires_grad_(True) for p in lm.parameters()]
        loss = lm.loss(b)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, params))
    assert torch.equal(out["block"][0], out["none"][0])
    for a, c in zip(out["block"][1], out["none"][1]):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# names, shapes, checkpoints
# ---------------------------------------------------------------------------

def test_interop_round_trip(arch):
    """reference params (bf16) -> port state dict -> reference names and
    stacked shapes, bit for bit."""
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
    # the generic map needs no prefixes for these families
    assert lm_arrays_from_state_dict(state).keys() == back.keys()
    lm.load_state_dict(state)
    again = lm_arrays_from_state_dict(lm.state_dict(), prefixes)
    assert all(np.array_equal(again[k], arrays[k]) for k in arrays)


def test_full_width_shapes_match_reference(arch):
    """The full configuration on the meta device: every parameter has the
    reference's shape and dtype, the counts agree, and nothing is
    allocated."""
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
    # the reference's initialisers: the norm scales zero, the weights at
    # their stddevs (cross-attention wk / wv at d_model ** -0.5 whatever
    # their input width, the frame projection at 512 ** -0.5)
    d = cfg.d_model
    for k, t in direct.state_dict().items():
        if t.dim() == 1:
            assert not t.any(), k
        elif k.endswith((".wk", ".wv", ".wq")):
            assert 0.7 * d ** -0.5 < float(t.float().std()) \
                < 1.3 * d ** -0.5, k
        elif k == "frontend_proj":
            assert 0.7 * FRAME_DIM ** -0.5 < float(t.float().std()) \
                < 1.3 * FRAME_DIM ** -0.5


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
    b = to_torch(batch_of(lm.cfg, B=2, S=16, seed=1))
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
    path = tmp_path / "c" / "step_0000000001" / "manifest.json"
    keys = [leaf["key"] for leaf in json.loads(path.read_text())["leaves"]]
    assert keys == [k for k, _ in ref_flatten(like)[0]]
