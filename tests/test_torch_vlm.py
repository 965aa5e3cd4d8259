"""The port's vlm family (Llama-3.2-Vision: self-attention layers with an
image cross-attention layer closing every unit) against the reference's,
on the CPU.

``GQAttention``'s cross path (K and V projected from the image context of
``vision_dim != d_model``, no rope, no mask) and the cross
``TransformerBlock`` take the same seeded numpy weights and inputs as the
reference's, in float32 to ``atol = rtol = 1e-5``.  The LM-level cases
(``tests/torch_media.py``, and the serving ones here) run the smoke model
at 5 layers: two units of one self-attention and one cross-attention
layer, and a self-attention tail; prefill plus stepwise decode (the image
context at every step) against the reference's at 1e-4, and against the
port's own forward at the reference's tolerances (2e-2, then 3e-2) and
at 1e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.attention import GQAttention as RefGQA
from repro.models.blocks import TransformerBlock as RefBlock
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefEngine

from repro_torch.configs import get_smoke
from repro_torch.interop import lm_reference_name
from repro_torch.launch import serve as launch_serve
from repro_torch.models.attention import GQAttention, KVCache
from repro_torch.models.blocks import TransformerBlock
from repro_torch.models.model import LM, VLMUnit
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

ARCH = "llama32_vision_11b"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def arch():
    return ARCH


def cross_configs():
    """(reference cfg, port cfg): the smoke configuration with an image
    width other than d_model (48 against 64) and two query heads per KV
    head."""
    return tuple(c.scaled(num_kv_heads=2, vlm=dataclasses.replace(
        c.vlm, vision_dim=48)) for c in configs(ARCH))


def inputs(cfg, B, S, T, seed):
    """x [B, S, d] and an image context [B, T, vision_dim], float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
            rng.normal(size=(B, T, cfg.vlm.vision_dim)).astype(np.float32))


def vision_of(cfg, B, seed):
    return np.random.default_rng(seed).normal(size=(
        B, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# the cross-attention layer and block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["grouped", "repeat"])
@pytest.mark.parametrize("T", [16, 7])
def test_cross_attention_matches_reference(T, layout):
    rcfg, pcfg = cross_configs()
    kvd = pcfg.vlm.vision_dim
    assert kvd != pcfg.d_model and pcfg.num_kv_heads < pcfg.num_heads
    ref, params, port = twin_layer(
        functools.partial(RefGQA, cross=True, kv_dim=kvd),
        functools.partial(GQAttention, kv_dim=kvd), rcfg, pcfg, "attn", 1)
    assert tuple(port.wk.shape) == (kvd, pcfg.num_kv_heads, pcfg.head_dim_)
    port.kv_layout = layout
    x, v = inputs(pcfg, 2, 12, T, seed=2)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want = np.asarray(ref.forward(params, jnp.asarray(x), jnp.asarray(pos),
                                  kv_src=jnp.asarray(v)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                   kv_src=torch.from_numpy(v)).numpy()
        # no rope on the cross path: the positions are never read
        none = port(torch.from_numpy(x), None,
                    kv_src=torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    np.testing.assert_array_equal(none, got)


def test_cross_block_matches_reference():
    rcfg, pcfg = cross_configs()
    ref, params, port = twin_layer(
        functools.partial(RefBlock, cross=True),
        functools.partial(TransformerBlock, cross=True), rcfg, pcfg, "x", 3)
    assert isinstance(port.attn, GQAttention)
    x, v = inputs(pcfg, 2, 10, 16, seed=4)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    want = np.asarray(ref.forward(params, jnp.asarray(x), jnp.asarray(pos),
                                  kv_src=jnp.asarray(v)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                   kv_src=torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)


def test_cross_block_is_gqa_under_an_mla_config():
    """A cross block builds GQA attention of the image width even where
    the config has MLA, as the reference does."""
    from repro_torch.models.config import VLMConfig
    cfg = get_smoke("deepseek_v2_236b").scaled(
        param_dtype="float32", vlm=VLMConfig(vision_dim=48))
    assert cfg.mla is not None
    cross = TransformerBlock(cfg, device=torch.device("cpu"), cross=True)
    plain = TransformerBlock(cfg, device=torch.device("cpu"))
    assert isinstance(cross.attn, GQAttention)
    assert type(plain.attn).__name__ == "MLAttention"
    assert tuple(cross.attn.wv.shape)[0] == 48


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def test_units_and_names():
    """Two units of one self + one cross layer and a tail; the unit's
    parts map to the reference's ``units.sa.b.*`` (unit, layer) and
    ``units.x.*`` (unit), with no special case."""
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="meta")
    assert list(lm.segments) == ["units", "tail"]
    assert len(lm.segments["units"]) == 2 and len(lm.segments["tail"]) == 1
    unit = lm.segments["units"][0]
    assert isinstance(unit, VLMUnit) and len(unit.sa) == 1
    assert lm.reference_prefixes == {"units": "", "units.sa": "b",
                                     "tail": "b"}
    names = dict(lm_reference_name(k, lm.reference_prefixes)
                 for k in ("segments.units.1.sa.0.attn.wq",
                           "segments.units.1.x.attn.wk", "vision_norm",
                           "segments.tail.0.mlp.w_up"))
    assert names == {"units.sa.b.attn.wq": (1, 0), "units.x.attn.wk": (1,),
                     "vision_norm": (), "tail.b.mlp.w_up": (0,)}


def kv_caches(caches):
    """Every layer's cache in nested per-segment caches."""
    if isinstance(caches, (list, tuple)):
        return [c for sub in caches for c in kv_caches(sub)]
    return [caches]


def test_cross_layers_have_no_cache():
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="cpu")
    flat = kv_caches(lm.init_caches(2, 8))
    # 2 units x 1 self layer, 1 tail layer
    assert len(flat) == 3 and all(isinstance(c, KVCache) for c in flat)


@pytest.mark.parametrize("k", [8, 12])
def test_prefill_and_decode_match_reference(k):
    """prefill + decode_step logits, the image context at every step,
    step by step against the reference's (float32)."""
    ref, params, port = twin_models(ARCH, seed=1)
    B, S = 2, k + 6
    b = batch_of(port.cfg, B, S, seed=2)
    toks, vis = b["tokens"], b["vision"]
    r_logits, r_caches = jax.jit(functools.partial(ref.prefill, s_max=S))(
        params, {"tokens": jnp.asarray(toks[:, :k]),
                 "vision": jnp.asarray(vis)})
    r_decode = jax.jit(ref.decode_step)
    tv = torch.from_numpy(vis)
    with torch.inference_mode():
        logits, caches = port.prefill(torch.from_numpy(toks[:, :k]), S,
                                      vision=tv)
        np.testing.assert_allclose(logits_of(logits, port.cfg),
                                   logits_of(r_logits, port.cfg), **F32_TOL)
        for t in range(k, S):
            step = toks[:, t:t + 1]
            r_logits, r_caches = r_decode(params, jnp.asarray(step),
                                          r_caches, vision=jnp.asarray(vis))
            logits, caches = port.decode_step(torch.from_numpy(step), caches,
                                              vision=tv)
            np.testing.assert_allclose(logits_of(logits, port.cfg),
                                       logits_of(r_logits, port.cfg),
                                       **F32_TOL)
    assert [c.pos for c in kv_caches(caches)] == [S] * 3


def test_prefill_decode_matches_forward():
    """The reference's test_prefill_decode_matches_forward on the port,
    at its tolerances, and within the port at 1e-4."""
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    B, S, k = 2, 16, 8
    b = batch_of(cfg, B, S, seed=3)
    toks, vis = torch.from_numpy(b["tokens"]), torch.from_numpy(b["vision"])
    with torch.inference_mode():
        full = lm(toks, vision=vis)
        logits, caches = lm.prefill(toks[:, :k], S, vision=vis)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, k - 1].numpy(), rtol=2e-2,
                                   atol=2e-2)
        steps = [logits[:, 0]]
        for t in range(k, S):
            logits, caches = lm.decode_step(toks[:, t:t + 1], caches,
                                            vision=vis)
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       full[:, t].numpy(), rtol=3e-2,
                                       atol=3e-2)
            steps.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(steps[:-1], 1),
                               full[:, k - 1:S - 1], **F32_TOL)


def test_the_image_context_is_required_and_read():
    """Without ``vision`` every entry point raises; another image moves
    every position's logits, and so does ``vision_norm``."""
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    b = batch_of(cfg, 2, 8, seed=4)
    toks = torch.from_numpy(b["tokens"])
    vis = torch.from_numpy(b["vision"])
    with torch.inference_mode():
        for call in (lambda: lm(toks), lambda: lm.prefill(toks, 9),
                     lambda: lm.loss({"tokens": toks,
                                      "labels": toks})):
            with pytest.raises(ValueError, match="image context"):
                call()
        _, caches = lm.prefill(toks, 9, vision=vis)
        with pytest.raises(ValueError, match="image context"):
            lm.decode_step(toks[:, :1], caches)
        a = lm(toks, vision=vis)
        other = lm(toks, vision=torch.from_numpy(vision_of(cfg, 2, 5)))
        lm.vision_norm.add_(0.5)
        normed = lm(toks, vision=vis)
    for c in (other, normed):
        assert bool(((c - a).abs().amax(-1) > 1e-4).all())


def test_greedy_generation_matches_reference():
    """ServeEngine.generate with the image context against the
    reference engine's greedy tokens."""
    ref, params, lm = twin_models(ARCH)
    b = batch_of(lm.cfg, 3, 16, seed=0)
    want = RefEngine(ref, params, RefServeConfig(max_seq=32)).generate(
        {"tokens": jnp.asarray(b["tokens"]),
         "vision": jnp.asarray(b["vision"])}, max_new=8, seed=1)
    got = ServeEngine(lm, ServeConfig(max_seq=32), device="cpu").generate(
        {"tokens": b["tokens"], "vision": b["vision"]}, max_new=8, seed=1)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    # another image, other tokens
    again = ServeEngine(lm, ServeConfig(max_seq=32), device="cpu").generate(
        {"tokens": b["tokens"], "vision": vision_of(lm.cfg, 3, 9)},
        max_new=8, seed=1)
    assert not np.array_equal(again, got)


def test_serve_steps_thread_the_image_context():
    """make_serve_step's prefill and decode take ``vision`` and equal the
    model's own calls; the engine rejects a prompt with no image."""
    _, cfg = configs(ARCH)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    b = batch_of(cfg, 2, 8, seed=6)
    toks, vis = torch.from_numpy(b["tokens"]), torch.from_numpy(b["vision"])
    prefill = make_serve_step(lm, mode="prefill")
    decode = make_serve_step(lm, mode="decode")
    with torch.inference_mode():
        l1, c1 = prefill(toks, s_max=10, vision=vis)
        l2, c2 = lm.prefill(toks, 10, vision=vis)
        assert torch.equal(l1, l2)
        d1, _ = decode(toks[:, :1], c1, vision=vis)
        d2, _ = lm.decode_step(toks[:, :1], c2, vision=vis)
        assert torch.equal(d1, d2)
    with pytest.raises(ValueError, match="image context"):
        ServeEngine(lm, ServeConfig(max_seq=12), device="cpu").generate(
            {"tokens": b["tokens"]}, 2)


def test_launch_serve_draws_the_reference_image(monkeypatch):
    """The serve CLI's image context: float32 [B, T, vision_dim] from
    default_rng(0) after the tokens, as the reference's launcher."""
    seen = {}

    def generate(self, batch, max_new, *, seed=0):
        seen.update(batch)
        return np.zeros((len(batch["tokens"]), max_new), np.int32)

    monkeypatch.setattr(ServeEngine, "generate", generate)
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--max-new",
                       "2"])
    cfg = get_smoke(ARCH)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(seen["tokens"],
                                  rng.integers(0, cfg.vocab, (2, 4)))
    want = rng.normal(size=(2, cfg.vlm.num_image_tokens,
                            cfg.vlm.vision_dim)).astype(np.float32)
    assert seen["vision"].dtype == np.float32
    np.testing.assert_array_equal(seen["vision"], want)
