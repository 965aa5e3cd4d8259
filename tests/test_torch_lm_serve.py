"""The port's LM serving engine and feature provider against the
reference's, on the CPU.

``repro_torch.serve.ServeEngine(device="cpu")`` generates from the same
smoke weights as ``repro.serve.engine.ServeEngine`` (copied through
``interop.lm_state_dict_from_arrays``, float32, 2 layers; gemma3_4b
keeps its 4): greedy tokens are held equal.  Sampling draws from a
``torch.Generator`` seeded by ``seed``, so sampled tokens are held to
the engine's own contract (reproducible per seed, different across
seeds), not to jax's generator.  ``RelationalFeatureProvider`` over
``repro_torch.summary.JoinService(device="cpu")`` is held bit for bit
to the reference's provider over the reference's service on the same
Last.fm-like catalog, before and after an append, and its rebuild after
an append runs once under a stampede of 8 threads.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as ref_get_smoke
from repro.models.model import LM as RefLM
from repro.relational.synth import lastfm_like as ref_lastfm_like
from repro.serve.engine import RelationalFeatureProvider as RefProvider
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefEngine
from repro.summary.service import JoinService as RefService

from repro_torch.configs import get_smoke
from repro_torch.interop import lm_state_dict_from_arrays
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.obs.metrics import REGISTRY
from repro_torch.relational.synth import lastfm_like
from repro_torch.serve import (JoinServer, RelationalFeatureProvider,
                               ServeConfig, ServeEngine, make_serve_step)
from repro_torch.summary import JoinService

import torch_threads  # noqa: F401

# depth tier: jax compiles the reference engine's prefill and decode
pytestmark = pytest.mark.slow

LASTFM = dict(n_users=40, n_artists=30, artists_per_user=4,
              friends_per_user=3)
APPEND = {"userID": np.asarray([0, 3, 41, 7], np.int64),
          "friendID": np.asarray([5, 42, 2, 1], np.int64)}
AGGS = {"n": "count", "total": ("sum", "A2")}


def twin(arch, seed=0):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    if arch != "gemma3_4b":
        kw["num_layers"] = 2
    rcfg, cfg = ref_get_smoke(arch).scaled(**kw), get_smoke(arch).scaled(**kw)
    ref = RefLM(rcfg)
    params = ref.init(jax.random.key(seed))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_state_dict_from_arrays(
        cfg, {k: np.asarray(v, np.float32) for k, v in params.items()}))
    return ref, params, lm


def prompts(cfg, B=3, S=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma3_4b", "starcoder2_3b",
                                  "nemotron_4_15b"])
def test_greedy_generation_matches_reference(arch):
    ref, params, lm = twin(arch)
    toks = prompts(lm.cfg)
    want = RefEngine(ref, params, RefServeConfig(max_seq=32)).generate(
        {"tokens": jnp.asarray(toks)}, max_new=8, seed=1)
    eng = ServeEngine(lm, ServeConfig(max_seq=32), device="cpu")
    got = eng.generate({"tokens": toks}, max_new=8, seed=1)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_greedy_is_seed_independent_and_sampling_is_seeded():
    _, _, lm = twin("qwen3_8b")
    toks = {"tokens": torch.from_numpy(prompts(lm.cfg, B=4))}
    greedy = ServeEngine(lm, ServeConfig(max_seq=48), device="cpu")
    np.testing.assert_array_equal(greedy.generate(toks, 8, seed=1),
                                  greedy.generate(toks, 8, seed=2))
    hot = ServeEngine(lm, ServeConfig(max_seq=48, temperature=1.0),
                      device="cpu")
    a, b = hot.generate(toks, 8, seed=1), hot.generate(toks, 8, seed=2)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, hot.generate(toks, 8, seed=1))
    assert ((a >= 0) & (a < lm.cfg.vocab)).all()


@pytest.mark.parametrize("max_new", [0, -1])
def test_generate_refuses_fewer_than_one_token(max_new):
    """As the reference, whose empty concatenation raises: no tokens is
    no generation (the port's used to return one token per row)."""
    _, _, lm = twin("qwen3_8b")
    toks = {"tokens": torch.from_numpy(prompts(lm.cfg, B=2, S=8))}
    eng = ServeEngine(lm, ServeConfig(max_seq=16), device="cpu")
    with pytest.raises(ValueError, match="max_new must be at least 1"):
        eng.generate(toks, max_new)
    assert eng.generate(toks, 1).shape == (2, 1)


def test_serve_steps_are_the_model_entry_points():
    _, _, lm = twin("starcoder2_3b")
    toks = torch.from_numpy(prompts(lm.cfg, B=2, S=8))
    prefill = make_serve_step(lm, mode="prefill")
    decode = make_serve_step(lm, mode="decode")
    with torch.inference_mode():
        logits, caches = prefill(toks, s_max=12)
        want, want_caches = lm.prefill(toks, s_max=12)
        assert torch.equal(logits, want)
        nxt = logits.argmax(-1)
        assert torch.equal(decode(nxt, caches)[0],
                           lm.decode_step(nxt, want_caches)[0])
    with pytest.raises(ValueError):
        make_serve_step(lm, mode="train")


def test_engine_refuses_a_model_on_another_device(monkeypatch):
    _, _, lm = twin("qwen3_8b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="the model is on cpu"):
        ServeEngine(lm, ServeConfig(max_seq=8), device="cuda")


# ---------------------------------------------------------------------------
# relational features
# ---------------------------------------------------------------------------

@pytest.fixture()
def services():
    rcat, rqs = ref_lastfm_like(**LASTFM)
    cat, qs = lastfm_like(**LASTFM)
    ref = RefProvider(RefService(rcat), rqs["lastfm_A1"], key_var="U1",
                      aggs=AGGS)
    svc = JoinService(cat, device="cpu")
    port = RelationalFeatureProvider(svc, qs["lastfm_A1"], key_var="U1",
                                     aggs=AGGS)
    return ref, port


def test_features_match_reference_across_an_append(services):
    ref, port = services
    keys = np.asarray([0, 1, 2, 39, 41, 1000, 7])      # 41, 1000: unknown
    before = port.features(keys)
    assert before.dtype == np.float32 and before.shape == (7, 2)
    np.testing.assert_array_equal(before, ref.features(keys))
    np.testing.assert_array_equal(port.features(keys), before)   # memo
    ref.service.append("user_friends", APPEND)
    port.service.append("user_friends", APPEND)
    after = port.features(keys)
    np.testing.assert_array_equal(after, ref.features(keys))
    assert after[0, 0] > before[0, 0]
    assert port.service.stats()["refreshed_requests"] >= 1


def test_features_through_a_server_equal_the_memo(services):
    ref, port = services
    keys = np.arange(45)
    server = JoinServer(port.service)
    via = RelationalFeatureProvider(port.service, port.query, key_var="U1",
                                    aggs=AGGS, plan=port.plan, server=server)
    np.testing.assert_array_equal(via.features(keys), port.features(keys))
    np.testing.assert_array_equal(via.features(keys), ref.features(keys))


def test_feature_rebuild_runs_once_under_a_stampede(services):
    _, port = services
    keys = np.arange(10)
    counter = REGISTRY.counter("serve.feature_recomputes")
    base = counter.value
    warm = port.features(keys)
    assert counter.value - base == 1
    port.service.append("user_friends", APPEND)

    entered, release = threading.Event(), threading.Event()
    real_table = port._feature_table

    def gated_table():
        entered.set()
        assert release.wait(10.0)
        return real_table()

    port._feature_table = gated_table
    N = 8
    outs, errors = [None] * N, []

    def worker(i):
        try:
            outs[i] = port.features(keys)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(N)]
    ts[0].start()
    assert entered.wait(10.0)
    for t in ts[1:]:
        t.start()
    deadline = time.monotonic() + 10.0
    while sum(fl.waiters
              for fl in port._flight._flights.values()) < N - 1:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    release.set()
    for t in ts:
        t.join(10.0)
        assert not t.is_alive()
    assert not errors
    assert counter.value - base == 2          # warm + ONE stampede rebuild
    assert outs[0][0, 0] > warm[0, 0]         # user 0 gained a friend
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_attach_features_returns_a_device_tensor(services):
    _, port = services
    _, _, lm = twin("qwen3_8b")
    batch = {"tokens": prompts(lm.cfg, B=3)}
    plain = ServeEngine(lm, ServeConfig(max_seq=24), device="cpu")
    assert plain.attach_features(batch, np.arange(3)) is batch
    eng = ServeEngine(lm, ServeConfig(max_seq=24), feature_provider=port,
                      device="cpu")
    out = eng.attach_features(batch, np.asarray([4, 0, 2]))
    assert out is not batch and out["tokens"] is batch["tokens"]
    feats = out["features"]
    assert isinstance(feats, torch.Tensor) and feats.dtype == torch.float32
    np.testing.assert_array_equal(feats.numpy(),
                                  port.features(np.asarray([4, 0, 2])))
    # features ride along; the tokens served are the prompt's
    np.testing.assert_array_equal(eng.generate(out, 4),
                                  plain.generate(batch, 4))


@pytest.mark.parametrize("arch", ["qwen3_8b", "zamba2_2p7b", "xlstm_350m",
                                  "llama32_vision_11b"])
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
    # an encoder has no decode path, as in the reference's launcher
    with pytest.raises(SystemExit, match="encoder-only; no decode path"):
        launch_serve.main(["--arch", "hubert_xlarge", "--smoke",
                           "--device", "cpu"])
