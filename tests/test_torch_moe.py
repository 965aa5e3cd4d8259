"""The port's moe family (granite-moe, deepseek-v2) against the
reference's, on the CPU.

``repro_torch.models.moe.MoEBlock`` and ``attention.MLAttention`` take
the same seeded numpy weights and inputs as the reference's
``MoEBlock`` / ``MLAttention``; the LM cases build the reference's smoke
model (2 layers: deepseek's are one dense and one MoE layer), initialise
it with ``LM.init`` and load the same weights into the port through
``interop.lm_state_dict_from_arrays``.

Tolerances: ``MoEBlock`` in float32 to ``atol = rtol = 1e-5`` at
capacity factors 0.01 (every expert keeps one slot, so equal outputs
show that the same slots were dropped), 1.25 (the configs') and 64
(drop-free); ``MLAttention`` and LM logits in float32 to 1e-4, bfloat16
logits to ``1e-2 * max|reference logits|``.  The LM's decode steps run
at the configs' capacity, so a step's ``B`` tokens may drop slots, as in
the reference.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import flash as ref_flash
from repro.models.attention import MLAttention as RefMLA
from repro.models.layers import ParamCollector
from repro.models.model import LM as RefLM
from repro.models.moe import MoEBlock as RefMoE
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefEngine

from repro_torch.configs import get_config, get_smoke
from repro_torch.interop import (lm_arrays_from_state_dict,
                                 lm_reference_name,
                                 lm_state_dict_from_arrays)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import flash
from repro_torch.models.attention import KVCache, MLAttention
from repro_torch.models.model import LM
from repro_torch.models.moe import MoEBlock, capacity
from repro_torch.serve import ServeConfig, ServeEngine

from test_torch_models import (F32_TOL, assert_bf16_close, port_logits,
                               real_logits, tokens)

# depth tier: jax compiles each reference model's scans
pytestmark = pytest.mark.slow

MOE = ["granite_moe_1b_a400m", "deepseek_v2_236b"]
CPU = torch.device("cpu")


def configs(arch, dtype="float32", capacity_factor=None, **extra):
    """(reference cfg, port cfg): the same 2-layer smoke configuration."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype, num_layers=2, **extra)
    out = []
    for cfg in (ref_get_smoke(arch), get_smoke(arch)):
        cfg = cfg.scaled(**kw)
        if capacity_factor is not None:
            cfg = cfg.scaled(moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return tuple(out)


def twin_models(arch, dtype="float32", seed=0, capacity_factor=None):
    rcfg, pcfg = configs(arch, dtype, capacity_factor)
    ref = RefLM(rcfg)
    params = ref.init(jax.random.key(seed))
    port = LM(pcfg, device="cpu")
    port.load_state_dict(lm_state_dict_from_arrays(
        pcfg, {k: np.asarray(v, np.float32) for k, v in params.items()}))
    return ref, params, port


def twin_layer(ref_cls, port_cls, rcfg, pcfg, prefix, seed):
    """A reference layer and the port's on the same weights: the
    reference's initialisers, then seeded numpy norm scales (which they
    leave at 0)."""
    pc = ParamCollector()
    ref = ref_cls(rcfg, pc, prefix)
    rng = np.random.default_rng(seed)
    arrays = {k: np.asarray(v, np.float32)
              for k, v in sorted(pc.init(jax.random.key(seed)).items())}
    for k, a in arrays.items():
        if a.ndim == 1:
            arrays[k] = (rng.normal(size=a.shape) * 0.1).astype(np.float32)
    params = {k: jnp.asarray(v, pc.inits[k][2]) for k, v in arrays.items()}
    port = port_cls(pcfg, device=CPU)
    state = port.state_dict()
    assert {prefix + "." + k for k in state} == set(arrays)
    port.load_state_dict({k: torch.tensor(arrays[f"{prefix}.{k}"]).to(
        t.dtype) for k, t in state.items()})
    return ref, params, port


# ---------------------------------------------------------------------------
# MoEBlock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.01, 1.25, 64.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch, cf):
    rcfg, pcfg = configs(arch, capacity_factor=cf)
    ref, params, port = twin_layer(RefMoE, MoEBlock, rcfg, pcfg, "moe", 1)
    assert port.router.dtype == torch.float32
    x = np.random.default_rng(2).normal(size=(3, 16, pcfg.d_model)).astype(
        np.float32)
    want = np.asarray(ref(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # one decode step's tokens: n_tok = B, as in the reference
    want1 = np.asarray(ref(params, jnp.asarray(x[:, :1])))
    with torch.inference_mode():
        got1 = port(torch.from_numpy(x[:, :1])).numpy()
    np.testing.assert_allclose(got1, want1, atol=1e-5, rtol=1e-5)


def test_moe_top_k_breaks_ties_by_the_lower_expert():
    """Equal router columns give equal probabilities: the lower expert
    index wins, as jax.lax.top_k decides."""
    rcfg, pcfg = configs("granite_moe_1b_a400m", capacity_factor=64.0)
    ref, params, port = twin_layer(RefMoE, MoEBlock, rcfg, pcfg, "moe", 3)
    router = np.asarray(params["moe.router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    params["moe.router"] = jnp.asarray(router)
    port.router.copy_(torch.from_numpy(router))
    x = np.random.default_rng(4).normal(size=(2, 8, pcfg.d_model)).astype(
        np.float32)
    xt = torch.from_numpy(x.reshape(-1, pcfg.d_model))
    top_e, _ = port.route(xt)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, pcfg.d_model))
                           @ jnp.asarray(router), -1)
    _, want_e = jax.lax.top_k(probs, pcfg.moe.experts_per_token)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want_e))
    # the tied experts 1-3: never 2 or 3 without 1
    e = top_e.numpy()
    assert ((e == 1).any(1) | ~((e == 2) | (e == 3)).any(1)).all()
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(params, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,n_tok,cap", [
    ("deepseek_v2_236b", 8, 1), ("granite_moe_1b_a400m", 8, 3),
    ("deepseek_v2_236b", 4 * 3072, 576), ("granite_moe_1b_a400m", 4, 2)])
def test_capacity_is_the_reference_rule(arch, n_tok, cap):
    """The full configs' capacities: decode steps of B tokens get B*k/E
    slots per expert times 1.25, rounded up, at least one."""
    m = get_config(arch).moe
    got = capacity(n_tok, m.experts_per_token, m.num_experts,
                   m.capacity_factor)
    want = max(int(np.ceil(n_tok * m.experts_per_token / m.num_experts
                           * m.capacity_factor)), 1)
    assert got == want == cap


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_is_sparse_and_weighted(arch):
    """The reference's test_moe_routing_is_sparse_and_weighted: finite
    logits, and a capacity factor near 0 drops slots, which moves them."""
    _, params, port = twin_models(arch, seed=3)
    _, _, starved = twin_models(arch, seed=3, capacity_factor=0.01)
    toks = torch.from_numpy(tokens(port.cfg, (2, 32), seed=5))
    with torch.inference_mode():
        out, out2 = port(toks), starved(toks)
    assert torch.isfinite(out[..., :port.cfg.vocab]).all()
    assert float((out - out2).abs().max()) > 0
    # each token's routing weights: k experts, summing to 1
    moe = next(m for m in port.modules() if isinstance(m, MoEBlock))
    x = torch.randn(64, port.cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    e, w = moe.route(x)
    k = port.cfg.moe.experts_per_token
    assert e.shape == w.shape == (64, k)
    assert (e.sort(-1).values.diff(dim=-1) > 0).all()   # k distinct
    torch.testing.assert_close(w.sum(-1), torch.ones(64))


# ---------------------------------------------------------------------------
# MLAttention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["dense", "online"])
@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_matches_reference(q_lora, path, monkeypatch):
    """forward, prefill (the cached latent too) and absorbed decode
    steps against the reference, float32, on the dense path and on the
    online path (DENSE_LIMIT = 1 in both packages)."""
    rcfg, pcfg = configs("deepseek_v2_236b")
    rcfg = rcfg.scaled(mla=dataclasses.replace(rcfg.mla, q_lora_rank=q_lora))
    pcfg = pcfg.scaled(mla=dataclasses.replace(pcfg.mla, q_lora_rank=q_lora))
    ref, params, port = twin_layer(RefMLA, MLAttention, rcfg, pcfg, "attn",
                                   7 + q_lora)
    assert ("wq_a" in dict(port.named_parameters())) == bool(q_lora)
    if path == "online":
        monkeypatch.setattr(flash, "DENSE_LIMIT", 1)
        monkeypatch.setattr(ref_flash, "DENSE_LIMIT", 1)
    B, S, k = 2, 16, 10
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, S, pcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    tpos = torch.from_numpy(pos).long()
    want = np.asarray(ref.forward(params, jnp.asarray(x), jnp.asarray(pos)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), tpos).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)

    r_cache = ref.init_cache(B, S)
    cache = port.init_cache(B, S)
    m = pcfg.mla
    assert cache.v is None and tuple(cache.k.shape) == (
        B, S, m.kv_lora_rank + m.rope_head_dim)
    r_y, r_cache = ref.prefill(params, jnp.asarray(x[:, :k]),
                               jnp.asarray(pos[:, :k]), r_cache)
    with torch.inference_mode():
        y, cache = port.prefill(torch.from_numpy(x[:, :k]), tpos[:, :k],
                                cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(r_y), **F32_TOL)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(r_cache.k),
                                   **F32_TOL)
        for t in range(k, S):
            r_y, r_cache = ref.decode(params, jnp.asarray(x[:, t:t + 1]),
                                      r_cache)
            y, cache = port.decode(torch.from_numpy(x[:, t:t + 1]), cache)
            np.testing.assert_allclose(y.numpy(), np.asarray(r_y),
                                       **F32_TOL)
            # the absorbed step equals the expanded forward's position t
            np.testing.assert_allclose(y.numpy()[:, 0], got[:, t],
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(r_cache.k),
                                   **F32_TOL)
    assert cache.pos == S == int(r_cache.pos)
    with pytest.raises(ValueError, match="cache full"):
        port.decode(torch.from_numpy(x[:, :1]), cache)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_reference(arch, dtype):
    ref, params, port = twin_models(arch, dtype)
    assert list(port.segments) == (["dense0", "moe"]
                                   if arch == "deepseek_v2_236b" else ["moe"])
    toks = tokens(port.cfg, (2, 32), seed=1)
    want = real_logits(jax.jit(ref.forward)(
        params, {"tokens": jnp.asarray(toks)}), port.cfg)
    with torch.inference_mode():
        out = port(torch.from_numpy(toks))
    assert out.shape == (2, 32, port.vocab_padded)
    got = port_logits(out, port.cfg)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch, dtype):
    """prefill + decode_step logits, step by step, against the
    reference's, at the configs' capacity (a step's 3 tokens may drop
    slots)."""
    ref, params, port = twin_models(arch, dtype, seed=1)
    B, S, k = 3, 16, 8
    toks = tokens(port.cfg, (B, S), seed=2)
    close = (functools.partial(np.testing.assert_allclose, **F32_TOL)
             if dtype == "float32" else assert_bf16_close)
    r_logits, r_caches = jax.jit(functools.partial(ref.prefill, s_max=S))(
        params, {"tokens": jnp.asarray(toks[:, :k])})
    r_decode = jax.jit(ref.decode_step)
    with torch.inference_mode():
        logits, caches = port.prefill(torch.from_numpy(toks[:, :k]), S)
        close(port_logits(logits, port.cfg), real_logits(r_logits, port.cfg))
        for t in range(k, S):
            step = toks[:, t:t + 1]
            r_logits, r_caches = r_decode(params, jnp.asarray(step),
                                          r_caches)
            logits, caches = port.decode_step(torch.from_numpy(step), caches)
            close(port_logits(logits, port.cfg),
                  real_logits(r_logits, port.cfg))
    layers = [c for seg in caches for c in seg]
    assert all(isinstance(c, KVCache) and c.pos == S for c in layers)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_matches_forward(arch):
    """The reference's test_prefill_decode_matches_forward on the port
    alone: stepwise logits equal the teacher-forced forward's, float32,
    drop-free (capacity factor 64); deepseek's decode is the absorbed
    form against the expanded forward."""
    _, pcfg = configs(arch, capacity_factor=64.0)
    lm = LM(pcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    B, S, k = 2, 16, 8
    toks = torch.from_numpy(tokens(pcfg, (B, S), seed=3))
    with torch.inference_mode():
        full = lm(toks)
        logits, caches = lm.prefill(toks[:, :k], S)
        steps = [logits[:, 0]]
        for t in range(k, S - 1):
            logits, caches = lm.decode_step(toks[:, t:t + 1], caches)
            steps.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1), full[:, k - 1:S - 1],
                               **F32_TOL)


@pytest.mark.parametrize("arch", MOE)
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
# interop, shapes, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_interop_round_trip(arch):
    """reference params (bf16, the router float32) -> port state dict ->
    reference names and stacked shapes, bit for bit; a reference
    parameter with no place in the port raises."""
    rcfg, pcfg = configs(arch, "bfloat16")
    params = RefLM(rcfg).init(jax.random.key(5))
    arrays = {k: np.asarray(v, np.float32) for k, v in params.items()}
    state = lm_state_dict_from_arrays(pcfg, arrays)
    for key, t in state.items():
        want = params[lm_reference_name(key)[0]].dtype
        assert str(t.dtype) == f"torch.{want}", key
    assert any(k.endswith("moe.router") for k in state)
    back = lm_arrays_from_state_dict(state)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state)
    again = lm_arrays_from_state_dict(lm.state_dict())
    assert all(np.array_equal(again[k], arrays[k]) for k in arrays)
    extra = "moe.b.moe.w_extra"
    with pytest.raises(ValueError, match="no place"):
        lm_state_dict_from_arrays(pcfg, dict(arrays, **{extra: arrays[
            "moe.b.moe.router"]}))


@pytest.mark.parametrize("arch", MOE)
def test_full_width_shapes_match_reference(arch):
    """The full configuration on the meta device: every parameter has
    the reference's shape and dtype (the router float32, the rest
    bfloat16), and nothing is allocated."""
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
        assert all(str(dt) == f"torch.{want.dtype}" for _, _, dt in parts)
    routers = [r for r in ref_shapes if r.endswith(".router")]
    assert routers and all(str(ref_shapes[r].dtype) == "float32"
                           for r in routers)


@pytest.mark.parametrize("arch", MOE)
def test_launch_serve_cli_serves_a_batch_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--features", "--batch", "2", "--prompt-len", "8",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "request features:" in out
    rows = [ln for ln in out.splitlines() if ln.startswith("request ")
            and ":" in ln and "features" not in ln]
    assert len(rows) == 2 and all(len(eval(r.split(": ", 1)[1])) == 3
                                  for r in rows)
