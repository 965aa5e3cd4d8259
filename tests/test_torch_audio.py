"""The port's audio family (HuBERT: a non-causal encoder over frame
embeddings, with an untied head) against the reference's, on the CPU.

The non-causal ``TransformerBlock`` takes the same seeded numpy weights
and inputs as the reference's, on the dense path (64 frames) and on the
online path (3,072 frames, above ``flash.DENSE_LIMIT``), in float32 to
``atol = rtol = 1e-5``.  The LM-level cases (``tests/torch_media.py``,
and the encoder ones here) run the smoke model at 4 layers; the encode
step's logits against the reference's ``make_serve_step(mode="prefill")``
at ``atol = rtol = 1e-4``.  The non-causality check: another last frame
moves position 0's logits, where the same weights under a causal mask
leave them bit-equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import flash as ref_flash
from repro.models.blocks import TransformerBlock as RefBlock
from repro.serve.engine import make_serve_step as ref_make_serve_step

from repro_torch.configs import get_config
from repro_torch.models import flash
from repro_torch.models.blocks import TransformerBlock
from repro_torch.models.model import FRAME_DIM, LM
from repro_torch.serve import ServeConfig, ServeEngine, make_serve_step

from test_torch_moe import twin_layer
from torch_media import (F32_TOL, batch_of, configs, logits_of,  # noqa: F401
                         test_checkpoint_keys_equal_the_reference_flatten,
                         test_forward_matches_reference,
                         test_full_width_shapes_match_reference,
                         test_interop_round_trip,
                         test_loss_and_grads_match_reference,
                         test_meta_build_then_init_equals_a_direct_build,
                         test_microbatched_step_splits_every_input,
                         test_port_checkpoint_restores_in_the_reference,
                         test_reference_checkpoint_restores_in_the_port,
                         test_remat_and_no_remat_grads_are_bit_equal,
                         test_train_step_matches_reference, twin_models)

# depth tier: jax compiles each reference model's scans
pytestmark = pytest.mark.slow

ARCH = "hubert_xlarge"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def arch():
    return ARCH


def frames(B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, FRAME_DIM)).astype(np.float32)


# ---------------------------------------------------------------------------
# the non-causal block, dense and online
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,online", [(64, False), (3072, True)])
def test_noncausal_block_matches_reference(S, online):
    rcfg, pcfg = configs(ARCH)
    assert not pcfg.causal
    assert flash.should_chunk(S, S) == online == ref_flash.should_chunk(S, S)
    ref, params, port = twin_layer(RefBlock, TransformerBlock, rcfg, pcfg,
                                   "b", 1)
    B = 1 if online else 2
    x = np.random.default_rng(2).normal(
        size=(B, S, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = np.asarray(jax.jit(ref.forward)(params, jnp.asarray(x),
                                           jnp.asarray(pos)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


def test_online_and_dense_noncausal_paths_agree(monkeypatch):
    """At 3,072 frames the online path; with the limit raised, the dense
    one on the same weights: equal to 1e-5, and neither masks."""
    _, cfg = configs(ARCH)
    block = TransformerBlock(cfg, device=torch.device("cpu"))
    from repro_torch.models.layers import init_normal
    init_normal(block, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 3072, cfg.d_model)).astype(np.float32))
    pos = torch.arange(3072)[None]
    with torch.inference_mode():
        online = block(x, pos)
        monkeypatch.setattr(flash, "DENSE_LIMIT", 1 << 24)
        dense = block(x, pos)
        x2 = x.clone()
        x2[:, -1] += 1.0
        moved = block(x2, pos)
    torch.testing.assert_close(online, dense, **LAYER_TOL)
    assert float((moved[:, 0] - dense[:, 0]).abs().max()) > 1e-5


# ---------------------------------------------------------------------------
# the encoder LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 3072])
def test_the_encoder_is_not_causal(S):
    """Another last frame moves position 0's logits (S = 16: the dense
    path; 3,072: the online one); under a causal mask the same weights
    leave them bit-equal."""
    _, cfg = configs(ARCH)
    out = {}
    for causal in (False, True):
        lm = LM(cfg.scaled(causal=causal), device="cpu",
                generator=torch.Generator().manual_seed(5))
        fr = torch.from_numpy(frames(1, S, 6))
        fr2 = fr.clone()
        fr2[:, -1] = torch.from_numpy(frames(1, 1, 7))[:, 0]
        with torch.inference_mode():
            out[causal] = (lm(fr)[:, 0] - lm(fr2)[:, 0]).abs().max()
    assert float(out[False]) > 1e-4
    assert float(out[True]) == 0.0


def test_encode_step_matches_reference():
    """make_serve_step(mode="prefill") is the encode step: the forward's
    logits at every frame, against the reference's."""
    ref, params, lm = twin_models(ARCH, seed=1)
    fr = frames(3, 24, 8)
    want = jax.jit(ref_make_serve_step(ref, mode="prefill"))(
        params, {"frames": jnp.asarray(fr)})
    encode = make_serve_step(lm, mode="prefill")
    with torch.inference_mode():
        got = encode(torch.from_numpy(fr))
        assert torch.equal(got, lm(torch.from_numpy(fr)))
    assert got.shape == (3, 24, lm.vocab_padded)
    np.testing.assert_allclose(logits_of(got, lm.cfg),
                               logits_of(want, lm.cfg), **F32_TOL)


def test_prefill_on_frames_matches_reference():
    """The reference's prefill works on frames: the last frame's logits
    and the K/V caches it fills ([B, S, KV, hd] there, heads-major
    here)."""
    ref, params, lm = twin_models(ARCH, seed=2)
    fr = frames(2, 12, 9)
    r_logits, r_caches = jax.jit(functools.partial(ref.prefill, s_max=16))(
        params, {"frames": jnp.asarray(fr)})
    with torch.inference_mode():
        logits, caches = lm.prefill(torch.from_numpy(fr), 16)
    np.testing.assert_allclose(logits_of(logits, lm.cfg),
                               logits_of(r_logits, lm.cfg), **F32_TOL)
    (rc,), (pc,) = r_caches, caches
    for i, c in enumerate(pc):
        assert c.pos == 12
        np.testing.assert_allclose(c.k.transpose(1, 2).numpy(),
                                   np.asarray(rc.k)[i], **F32_TOL)
        np.testing.assert_allclose(c.v.transpose(1, 2).numpy(),
                                   np.asarray(rc.v)[i], **F32_TOL)


def test_encoder_has_no_decode_and_does_not_generate():
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="cpu")
    fr = torch.from_numpy(frames(2, 8, 10))
    _, caches = lm.prefill(fr, 9)
    with pytest.raises(ValueError, match="encoder"):
        lm.decode_step(torch.zeros((2, 1), dtype=torch.int64), caches)
    with pytest.raises(ValueError, match="encoder"):
        make_serve_step(lm, mode="decode")(
            torch.zeros((2, 1), dtype=torch.int64), caches)
    engine = ServeEngine(lm, ServeConfig(max_seq=16), device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        engine.generate({"tokens": np.zeros((2, 4), np.int64)}, 4)


def test_device_reads_a_parameter_every_family_has():
    """LM.device on a model with no embedding table; the engine reads
    it."""
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="cpu")
    assert not hasattr(lm, "embed")
    assert lm.device == torch.device("cpu")
    assert ServeEngine(lm, ServeConfig(max_seq=8), device="cpu").lm is lm
    assert LM(cfg, device="meta").device.type == "meta"


@pytest.mark.parametrize("tie", [False, True])
def test_padded_vocab_and_untied_head(tie):
    """HuBERT's 504 classes pad to 512 with the pad logits at -1e30; the
    head is its own matrix whatever ``tie_embeddings`` says, as in the
    reference."""
    ref, params, lm = twin_models(ARCH, seed=3, vocab=504,
                                  tie_embeddings=tie)
    assert lm.vocab_padded == 512 and tuple(lm.head.shape) == (
        lm.cfg.d_model, 512)
    assert set(params) >= {"frontend_proj", "head"} and "embed" not in params
    fr = frames(2, 16, 11)
    want = np.asarray(jax.jit(ref.forward)(params,
                                           {"frames": jnp.asarray(fr)}))
    with torch.inference_mode():
        got = lm(torch.from_numpy(fr)).numpy()
    assert (got[..., 504:] == -1e30).all()
    np.testing.assert_allclose(got[..., :504], want[..., :504], **F32_TOL)


def test_full_config_is_the_published_one():
    """hubert-xlarge at full size on the meta device: 48 non-causal
    blocks, 945,153,280 parameters (the reference's count)."""
    cfg = get_config(ARCH)
    lm = LM(cfg, device="meta")
    assert not cfg.causal and lm.encoder_only
    assert len(lm.segments["blocks"]) == 48
    assert sum(p.numel() for p in lm.parameters()) == 945_153_280
