"""The port's dense-family LM against the reference's, on the CPU.

Each case builds the reference's ``get_smoke`` model (2 layers; gemma3_4b
keeps its 4, so that one 2-local + 1-global unit and one tail layer
run), initialises it with ``LM.init``, and loads the same weights into
``repro_torch.models.model.LM(device="cpu")`` through
``interop.lm_state_dict_from_arrays``.  Inputs are drawn with numpy from
fixed seeds and passed to both as int32 / float32 arrays, so nothing
depends on jax's default integer width (importing ``repro.core.engine_jax``
turns x64 on process-wide).

Tolerances: float32 logits to ``atol = rtol = 1e-4``; bfloat16 logits
to ``1e-2 * max|reference logits|`` (about two bf16 steps at the top of
the range: the two packages round the same products in different
orders).  Kernel-free pieces (activations, norms, rope, the loss, the
online attention) are held to 1e-6 in float32.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import flash as ref_flash
from repro.models import layers as ref_layers
from repro.models.model import LM as RefLM

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.interop import (lm_arrays_from_state_dict,
                                 lm_reference_name,
                                 lm_state_dict_from_arrays)
from repro_torch.models import flash, layers
from repro_torch.models.attention import GQAttention
from repro_torch.models.model import LM

import torch_threads  # noqa: F401

# depth tier: jax compiles each reference model's scans
pytestmark = pytest.mark.slow

DENSE = ["qwen3_8b", "gemma3_4b", "starcoder2_3b", "nemotron_4_15b"]
# the moe family's tests are in test_torch_moe.py, the hybrid and ssm
# families' in test_torch_ssm.py and test_torch_xlstm.py, the vlm and
# audio families' in test_torch_vlm.py and test_torch_audio.py
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def smoke_pair(arch, dtype="float32", **extra):
    """(reference cfg, port cfg): the same smoke configuration."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **extra)
    if arch != "gemma3_4b":
        kw.setdefault("num_layers", 2)
    return ref_get_smoke(arch).scaled(**kw), get_smoke(arch).scaled(**kw)


def twin_models(arch, dtype="float32", seed=0, **extra):
    """The reference's (lm, params) and the port's LM on the same weights."""
    rcfg, pcfg = smoke_pair(arch, dtype, **extra)
    ref = RefLM(rcfg)
    params = ref.init(jax.random.key(seed))
    port = LM(pcfg, device="cpu")
    port.load_state_dict(lm_state_dict_from_arrays(
        pcfg, {k: np.asarray(v, np.float32) for k, v in params.items()}))
    return ref, params, port


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def real_logits(a, cfg):
    return np.asarray(a, np.float32)[..., :cfg.vocab]


def port_logits(t, cfg):
    return t.float().numpy()[..., :cfg.vocab]


def assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# model parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, dtype):
    ref, params, port = twin_models(arch, dtype)
    toks = tokens(port.cfg, (2, 32), seed=1)
    want = real_logits(jax.jit(ref.forward)(
        params, {"tokens": jnp.asarray(toks)}), port.cfg)
    with torch.inference_mode():
        out = port(torch.from_numpy(toks))
    assert out.shape == (2, 32, port.vocab_padded)
    assert out.dtype == torch.float32
    assert bool((out[..., port.cfg.vocab:] == -1e30).all()) \
        or port.vocab_padded == port.cfg.vocab
    got = port_logits(out, port.cfg)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    """prefill + decode_step logits, step by step, against the
    reference's (float32), and against the port's own teacher-forced
    forward (the reference's test_prefill_decode_matches_forward)."""
    ref, params, port = twin_models(arch, seed=1)
    B, S, k = 2, 16, 8
    toks = tokens(port.cfg, (B, S), seed=2)
    with torch.inference_mode():
        full = port_logits(port(torch.from_numpy(toks)), port.cfg)
        r_logits, r_caches = jax.jit(functools.partial(
            ref.prefill, s_max=S))(params,
                                   {"tokens": jnp.asarray(toks[:, :k])})
        r_decode = jax.jit(ref.decode_step)
        logits, caches = port.prefill(torch.from_numpy(toks[:, :k]), S)
        got = port_logits(logits, port.cfg)
        np.testing.assert_allclose(got, real_logits(r_logits, port.cfg),
                                   **F32_TOL)
        np.testing.assert_allclose(got[:, 0], full[:, k - 1], **F32_TOL)
        for t in range(k, S):
            step = toks[:, t:t + 1]
            r_logits, r_caches = r_decode(params, jnp.asarray(step),
                                          r_caches)
            logits, caches = port.decode_step(torch.from_numpy(step), caches)
            got = port_logits(logits, port.cfg)
            np.testing.assert_allclose(got, real_logits(r_logits, port.cfg),
                                       **F32_TOL)
            np.testing.assert_allclose(got[:, 0], full[:, t], **F32_TOL)
    assert {c.pos for c in kv_caches(caches)} == {S}


def kv_caches(caches):
    """Every layer's KVCache in nested per-segment caches."""
    if isinstance(caches, (list, tuple)):
        return [c for sub in caches for c in kv_caches(sub)]
    return [caches]


def set_layout(lm, layout):
    for m in lm.modules():
        if isinstance(m, GQAttention):
            m.kv_layout = layout


@pytest.mark.parametrize("arch,extra", [("qwen3_8b", {"num_kv_heads": 1}),
                                        ("starcoder2_3b", {})])
def test_grouped_and_repeated_kv_layouts_agree(arch, extra):
    """The port's grouped layout against the reference's "repeat" (K/V
    copied to every head), in the port and against the reference."""
    ref, params, port = twin_models(arch, seed=2, **extra)
    assert port.cfg.num_kv_heads < port.cfg.num_heads
    toks = tokens(port.cfg, (2, 16), seed=3)
    want = real_logits(jax.jit(ref.forward)(
        params, {"tokens": jnp.asarray(toks)}), port.cfg)
    runs = {}
    with torch.inference_mode():
        for layout in ("grouped", "repeat"):
            set_layout(port, layout)
            fwd = port_logits(port(torch.from_numpy(toks)), port.cfg)
            logits, caches = port.prefill(torch.from_numpy(toks[:, :8]), 16)
            steps = [port_logits(port.decode_step(
                torch.from_numpy(toks[:, t:t + 1]), caches)[0], port.cfg)
                for t in range(8, 12)]
            runs[layout] = (fwd, steps)
            np.testing.assert_allclose(fwd, want, **F32_TOL)
    np.testing.assert_allclose(runs["grouped"][0], runs["repeat"][0],
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(runs["grouped"][1], runs["repeat"][1]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_loss_matches_reference():
    ref, params, port = twin_models("qwen3_8b", seed=3)
    toks = tokens(port.cfg, (2, 16), seed=4)
    labels = tokens(port.cfg, (2, 16), seed=5)
    mask = (np.arange(16) < 12).astype(np.float32)[None].repeat(2, 0)
    for m in (None, mask):
        rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        pb = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
        if m is not None:
            rb["mask"], pb["mask"] = jnp.asarray(m), torch.from_numpy(m)
        with torch.inference_mode():
            got = float(port.loss(pb))
        assert got == pytest.approx(float(ref.loss(params, rb)), rel=1e-5)


# ---------------------------------------------------------------------------
# online attention and the dense/online switch
# ---------------------------------------------------------------------------

def qkv(B, Sq, Sk, KV, G, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, KV, G, hd)).astype(dtype),
            rng.normal(size=(B, Sk, KV, hd)).astype(dtype),
            rng.normal(size=(B, Sk, KV, hd)).astype(dtype))


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (True, 32, 0.0),
                                               (False, 0, 0.0),
                                               (True, 0, 20.0)])
def test_online_attention_matches_reference_small_chunks(causal, window, cap):
    q, k, v = qkv(2, 128, 128, 2, 3, 16, seed=6)
    kw = dict(causal=causal, window=window, softcap=cap, chunk_q=32,
              chunk_k=32)
    want = np.asarray(ref_flash.online_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = flash.online_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_online_attention_above_dense_limit():
    """Sq * Sk = 3072^2 > DENSE_LIMIT: the reference's 1024-blocks."""
    assert flash.should_chunk(3072, 3072)
    q, k, v = qkv(1, 3072, 3072, 1, 2, 16, seed=7)
    want = np.asarray(ref_flash.online_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = flash.online_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_dense_online_switch_at_the_limit():
    assert flash.DENSE_LIMIT == ref_flash.DENSE_LIMIT == 1 << 22
    for sq, sk in [(2048, 2048), (2048, 2049), (1, 1 << 23), (4096, 1024),
                   (4096, 1025), (3072, 3072), (1024, 1024)]:
        assert flash.should_chunk(sq, sk) == ref_flash.should_chunk(sq, sk)
    assert not flash.should_chunk(2048, 2048)       # == the limit: dense
    assert flash.should_chunk(2048, 2049)


def test_online_path_needs_whole_1024_blocks():
    """Above the limit the online path takes 1024-blocks, so a sequence
    that is not a whole number of them is refused, as the reference's
    assert refuses it."""
    q, k, v = qkv(1, 3000, 3000, 1, 1, 8, seed=8)
    assert flash.should_chunk(3000, 3000)
    with pytest.raises(ValueError, match="whole blocks"):
        flash.online_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True)
    with pytest.raises(AssertionError):
        ref_flash.online_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True)


def test_forced_online_path_in_model_matches_reference(monkeypatch):
    """DENSE_LIMIT = 1 in both packages: every attention chunks."""
    ref, params, port = twin_models("gemma3_4b", seed=4)
    toks = tokens(port.cfg, (1, 64), seed=9)
    with torch.inference_mode():
        dense = port_logits(port(torch.from_numpy(toks)), port.cfg)
    monkeypatch.setattr(flash, "DENSE_LIMIT", 1)
    monkeypatch.setattr(ref_flash, "DENSE_LIMIT", 1)
    want = real_logits(jax.jit(ref.forward)(
        params, {"tokens": jnp.asarray(toks)}), port.cfg)
    with torch.inference_mode():
        got = port_logits(port(torch.from_numpy(toks)), port.cfg)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, dense, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# kernel-free pieces
# ---------------------------------------------------------------------------

def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(ref_layers.activation_fn("gelu")(jnp.asarray(x)))
    got = layers.activation_fn("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4      # not the erf form


@pytest.mark.parametrize("name", ["silu", "relu2"])
def test_other_activations(name):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(ref_layers.activation_fn(name)(jnp.asarray(x)))
    got = layers.activation_fn(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if name == "relu2":
        np.testing.assert_array_equal(got, np.square(np.maximum(x, 0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_scales_by_one_plus_scale(dtype):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32) * 0.1
    tdt = getattr(torch, dtype)
    want = np.asarray(ref_layers.rms_norm(
        jnp.asarray(x, dtype), jnp.asarray(s, dtype), 1e-6), np.float32)
    got = layers.rms_norm(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(s).to(tdt), 1e-6)
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    zero = layers.rms_norm(torch.from_numpy(x), torch.zeros(64), 1e-6)
    np.testing.assert_allclose(
        zero.numpy(), x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6),
        rtol=1e-5)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 4 + 1
    scale, bias = rng.normal(size=(2, 64)).astype(np.float32)
    want = np.asarray(ref_layers.layer_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-6))
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), 1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_rope_rotates_split_halves():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(3000, 3040, dtype=np.int32), (2, 1))
    for theta in (10_000.0, 1_000_000.0):
        want = np.asarray(ref_layers.apply_rope(jnp.asarray(x),
                                                jnp.asarray(pos), theta))
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        layers.rope_frequencies(16, 1e6).numpy(),
        np.asarray(ref_layers.rope_frequencies(16, 1e6)), rtol=1e-6)
    # position 0 is the identity; halves, not interleaved pairs, rotate
    y = layers.apply_rope(torch.from_numpy(x[:, :1]),
                          torch.zeros((2, 1), dtype=torch.int64), 1e4)
    np.testing.assert_array_equal(y.numpy(), x[:, :1])
    one = np.zeros((1, 1, 1, 4), np.float32)
    one[..., 0] = 1.0
    r = layers.apply_rope(torch.from_numpy(one),
                          torch.ones((1, 1), dtype=torch.int64), 1e4)
    np.testing.assert_allclose(r.numpy()[0, 0, 0],
                               [np.cos(1.0), 0.0, np.sin(1.0), 0.0],
                               atol=1e-7)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(12)
    logits = rng.normal(size=(2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = float(ref_layers.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(layers.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------------------
# interop, building, unported families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_interop_round_trip(arch):
    """reference params (bf16) -> port state dict -> reference names and
    stacked shapes, bit for bit."""
    rcfg, pcfg = smoke_pair(arch, "bfloat16")
    params = RefLM(rcfg).init(jax.random.key(5))
    arrays = {k: np.asarray(v, np.float32) for k, v in params.items()}
    state = lm_state_dict_from_arrays(pcfg, arrays)
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    back = lm_arrays_from_state_dict(state)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state)
    again = lm_arrays_from_state_dict(lm.state_dict())
    assert all(np.array_equal(again[k], arrays[k]) for k in arrays)


def test_interop_refuses_mismatches():
    rcfg, pcfg = smoke_pair("qwen3_8b")
    arrays = {k: np.asarray(v, np.float32)
              for k, v in RefLM(rcfg).init(jax.random.key(6)).items()}
    with pytest.raises(ValueError, match="shape"):
        lm_state_dict_from_arrays(pcfg.scaled(d_ff=96), arrays)
    with pytest.raises(ValueError, match="no place"):
        lm_state_dict_from_arrays(pcfg, dict(arrays, extra=np.zeros(3)))
    missing = dict(arrays)
    del missing["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        lm_state_dict_from_arrays(pcfg, missing)


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_shapes_match_reference(arch):
    """The full configuration on the meta device: every parameter has
    the reference's shape and dtype, and nothing is allocated."""
    ref_shapes = RefLM(ref_get_config(arch)).abstract_params()
    lm = LM(get_config(arch), device="meta")
    assert all(p.device.type == "meta" for p in lm.parameters())
    by_ref = {}
    for key, t in lm.state_dict().items():
        ref, idx = lm_reference_name(key)
        by_ref.setdefault(ref, []).append((idx, tuple(t.shape), t.dtype))
    assert set(by_ref) == set(ref_shapes)
    for ref, parts in by_ref.items():
        want = ref_shapes[ref]
        lead = tuple(np.max([i for i, _, _ in parts], axis=0) + 1) \
            if parts[0][0] else ()
        assert lead + parts[0][1] == tuple(want.shape), ref
        assert len(parts) == int(np.prod(lead, dtype=np.int64))
        assert all(dt == torch.bfloat16 for _, _, dt in parts)
        assert str(want.dtype) == "bfloat16"


def test_meta_build_then_init_equals_a_direct_build():
    cfg = get_smoke("gemma3_4b")
    direct = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    lazy = LM(cfg, device="meta").to_empty(device="cpu")
    lazy.init_weights(torch.Generator().manual_seed(7))
    for (k, a), (_, b) in zip(direct.state_dict().items(),
                              lazy.state_dict().items()):
        assert torch.equal(a, b), k
    # the reference's initialisers: norms zero, weights at their stddev
    sd = direct.state_dict()
    assert not sd["final_norm"].any()
    w = sd["segments.units.0.loc.0.attn.wq"].float()
    assert 0.5 * cfg.d_model ** -0.5 < w.std() < 1.5 * cfg.d_model ** -0.5


# sha256 of each smoke model's state dict (keys, then float32 bytes) drawn
# from torch.Generator().manual_seed(3) on the CPU, taken before the vlm
# and audio families were added: adding them leaves every other family's
# drawing order, and so its weights, as they were
INIT_DIGESTS = {"qwen3_8b": "f8263b701989f0cb", "gemma3_4b": "2ab98f058fd47dd9",
                "granite_moe_1b_a400m": "55d3882105428c0b",
                "deepseek_v2_236b": "f3dffa344186ad9f",
                "zamba2_2p7b": "cea4ab2c0a3ec406",
                "xlstm_350m": "86cf4e8f08dda397"}


@pytest.mark.parametrize("arch", sorted(INIT_DIGESTS))
def test_seeded_weights_are_unchanged(arch):
    import hashlib
    lm = LM(get_smoke(arch), device="cpu",
            generator=torch.Generator().manual_seed(3))
    h = hashlib.sha256()
    for k, t in lm.state_dict().items():
        h.update(k.encode())
        h.update(t.float().numpy().tobytes())
    assert h.hexdigest()[:16] == INIT_DIGESTS[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_builds(arch):
    """Every architecture of the configs builds in the port (on the meta
    device at full size, on the CPU as its smoke model)."""
    full = LM(get_config(arch), device="meta")
    assert full.device.type == "meta"
    smoke = LM(get_smoke(arch), device="cpu")
    assert smoke.device == torch.device("cpu")
